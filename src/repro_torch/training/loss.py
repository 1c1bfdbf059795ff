"""Cross-entropy and accuracy (``repro/training/loss.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (..., V) logits and (...) int labels, in f32; ``mask``
    optionally weights the terms."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        w = mask.float()
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(nll)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    hit = (pred == labels.long()).float()
    if mask is not None:
        w = mask.float()
        return torch.sum(hit * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(hit)
