"""Plain PyTorch twins of the delta-codec kernels (``repro/kernels/delta_codec``).

The wrappers of ``kernel.py`` run these on CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card.

The scale is ``absmax * fl(1/qmax)``, floored at 1e-12: the reference
writes ``absmax / qmax``, and XLA folds a division by a constant into a
multiply by its f32 reciprocal in every jitted program (the fused round,
``encode_delta``, the Pallas kernel in interpret mode).  So q and the
scales here equal the JAX engines' bit for bit; the eager
``repro.kernels.delta_codec.ref.quantize_ref``, which really divides,
differs in the last bit of a few scales.  ``x / scale`` is a true division
and ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import numpy as np
import torch


def inv_qmax(bits: int) -> float:
    """fl32(1 / qmax) for a bit depth, as XLA's constant folding gives it."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    return float(np.float32(1.0) / qmax)


def quantize_ref(x: torch.Tensor, bits: int = 8):
    """x (M, block) float -> (q int8 (M, block), scale f32 (M, 1))."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    inv = torch.tensor(inv_qmax(bits), dtype=torch.float32, device=x.device)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) * inv
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
