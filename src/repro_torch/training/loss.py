"""Cross-entropy, the fused-head cross-entropy and accuracy
(``repro/training/loss.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import lm_logits
from repro_torch.sharding.apply import is_dtensor


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``_token_nll``; on DTensors it runs on each rank's shards, with the
    vocab dim made whole first: each mesh axis that splits the vocab splits
    the sequence instead (an all-to-all, no larger than the shard).
    DTensor's own gather along a split vocab dim would mask its partial
    sums for an embedding's layout, and its backward would build the
    logits' gradient at their global size."""
    if not is_dtensor(logits):
        return _token_nll(logits, labels)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = logits.ndim - 1
    want = tuple(Shard(last - 1) if isinstance(p, Shard) and p.dim == last
                 else Replicate() if p.is_partial() else p
                 for p in logits.placements)
    mesh = logits.device_mesh
    if want != tuple(logits.placements):
        logits = logits.redistribute(mesh, want)
    if tuple(labels.placements) != want:
        labels = labels.redistribute(mesh, want)
    return local_map(_token_nll, out_placements=(want,),
                     in_placements=(want, want), device_mesh=mesh)(logits,
                                                                   labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (..., V) logits and (...) int labels, in f32; ``mask``
    optionally weights the terms."""
    nll = _nll(logits, labels)
    if mask is not None:
        w = mask.float()
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(nll)


def fused_head_cross_entropy(head_params, embed_params, cfg, hidden: torch.Tensor,
                             labels: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             chunk: int = 512) -> torch.Tensor:
    """CE without materializing the full (B, S, V) logits tensor.

    The head projection and the logsumexp run per chunk of ``chunk``
    positions, each recomputed in the backward (``checkpoint``), so the
    live logits are (B, chunk, V).  The chunks' sums add in order, as the
    reference's ``lax.scan``."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"fused_head_cross_entropy: S={S} is not a multiple "
                         f"of chunk={chunk}")

    def chunk_loss(h, y, w):
        logits = lm_logits(head_params, embed_params, cfg, h).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
        return torch.sum((logz - gold) * w), torch.sum(w)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        w = (mask[:, sl].to(torch.float32) if mask is not None
             else torch.ones((B, chunk), dtype=torch.float32,
                             device=hidden.device))
        s, c = checkpoint(chunk_loss, hidden[:, sl], labels[:, sl], w,
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    hit = (pred == labels.long()).float()
    if mask is not None:
        w = mask.float()
        return torch.sum(hit * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(hit)
