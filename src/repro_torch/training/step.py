"""Forward-only serving steps (``repro/training/step.py``).

``make_prefill_step`` and ``make_decode_step`` only: the loss and the train
step wait for the zoo's training slice (ROADMAP.md, queue 1).  The steps
run on the model's device (``build_model``'s ``device``; the card by
default).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.registry import Model


def make_prefill_step(model: Model, opts: Optional[dict] = None) -> Callable:
    """Forward-only step (inference prefill / encoder encode).  ``batch``
    is ``models.inputs``' prefill structure: ``tokens``; ``embeds`` for
    audio; ``patch_embeds`` and ``positions`` for vlm."""

    @torch.no_grad()
    def step(params, batch: Dict[str, Any]):
        logits, _ = model.forward(params, batch, opts)
        return logits

    return step


def make_decode_step(model: Model, opts: Optional[dict] = None) -> Callable:
    """One-token serve step: (params, token, state, position) -> (logits, state)."""
    if model.decode is None:
        raise ValueError(f"{model.cfg.name} has no decode step")

    @torch.no_grad()
    def step(params, token, state, position):
        return model.decode(params, token, state, position, opts)

    return step
