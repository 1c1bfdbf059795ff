"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Counterpart of ``flash_attention_bh`` of
``repro/kernels/flash_attention/kernel.py``: forward online-softmax
attention over the folded ``(B·H, S, D)`` layout, grouped kv heads (the kv
row of q row ``bh`` is ``bh // group_size``), causal and sliding-window
masks with aligned ends (``Sq <= Sk``), f32 accumulation, output in q's
dtype.  q, k and v share one compute dtype, f32 or bf16.

On CPU tensors the wrapper runs the plain twin of ``ref.py``; on CUDA
tensors it checks dtype, shape, contiguity and alignment, allocates the
output with ``torch.empty``, launches on the current stream and raises on
a launch error.  There is no fallback from the card to the twin.  The
dtype picks the CUDA kernel: bf16 runs on the tensor cores (TMA loads,
``wgmma`` products, 128-row q tiles, p rounded to bf16 before p·v), f32
on the CUDA cores (64-row tiles, all in f32).  The reference's TPU tile
sizes (``block_q``, ``block_k``) have no counterpart: both kernels mask a
ragged tail themselves, so any ``S >= 1`` works (the reference asserts
``S % block == 0``).  The head dim is one of ``HEAD_DIMS``: 32, 64, 80
and 128 (80, hubert-xlarge's, runs at bf16 on the 128-wide tensor-core
layout, its extra columns zeros); any other D raises, where the
reference takes any.

``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (32, 64, 80, 128)    # the head dims both kernels take

LAUNCHES: Dict[str, int] = {"flash_attention_bh": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("flash_attention", {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _I],
}, "flash_error_string", LAUNCHES)
reset_launches = _LIB.reset


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       group_size: int = 1, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BKV, Sk, D) with BH = BKV * group_size.
    Returns (BH, Sq, D) in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention_bh: expected q (BH, Sq, D) and "
                         f"k, v (BKV, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    bkv, sk, dk = k.shape
    if bh != bkv * group_size or dk != d:
        raise ValueError(f"flash_attention_bh: BH={bh} != BKV={bkv} * "
                         f"group_size={group_size}, or head dims {d} != {dk}")
    if not 1 <= sq <= sk:
        raise ValueError(f"flash_attention_bh: need 1 <= Sq <= Sk (aligned "
                         f"ends), got Sq={sq}, Sk={sk}")
    dt = _build.compute_dtype("flash_attention_bh q", q)
    if _build.on_cpu(q, k, v):
        if k.dtype != dt or v.dtype != dt:
            raise TypeError(f"flash_attention_bh: q, k, v must share one "
                            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
        return ref.flash_attention_bh_ref(q, k, v, group_size, causal,
                                          window)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bh: head dim {d} not in "
                         f"{HEAD_DIMS}")
    _build.check("q", q, (bh, sq, d), dt, align=16)
    _build.check("k", k, (bkv, sk, d), dt, align=16)
    _build.check("v", v, (bkv, sk, d), dt, align=16)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _LIB.launch("flash_attention_bh", "flash_attention_fwd",
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, sq, sk, d, group_size, int(bool(causal)),
                    int(window), float(d ** -0.5),
                    int(dt == torch.bfloat16))
    return out
