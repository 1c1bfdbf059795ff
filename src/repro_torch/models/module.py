"""Param initialisers on a ``torch.Generator`` (``repro/models/module.py``).

Params are plain nested dicts of tensors.  The generator draws on the CPU
and the result moves to ``device``, so one seed gives the same weights on
every device.  The numbers differ from ``jax.random``'s for the same seed:
tests that compare the packages hand the JAX init across as numpy
(``repro_torch.convert``).
"""
from __future__ import annotations

import torch


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def normal(gen: torch.Generator, shape, scale: float, device=None
           ) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) * scale).to(device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device=None,
               scale: float | None = None) -> torch.Tensor:
    """Fan-in scaled truncated-normal (LeCun) weight (in_dim, out_dim)."""
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty(in_dim, out_dim)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(device)
