"""Wrapper of the WKV6 CUDA kernel (``csrc/wkv6.cu``).

Counterpart of ``wkv6_bh`` of ``repro/kernels/wkv6/kernel.py``: the RWKV6
recurrence per (b, h) over the folded ``(B·H, S, D)`` layout from a zero
state, f32 state, y in r's dtype and the final state (f32) out.

r, k and v share one compute dtype (f32 or bf16); w and u are f32.  The
model feeds w in f32 whatever the compute dtype (``_decay`` returns f32),
and rounding it to bf16 would change every result, so the wrapper takes
exactly these dtypes and raises on any other, on the CPU too.

On CPU tensors the wrapper runs the plain twin of ``ref.py``; on CUDA
tensors it checks shapes and contiguity, copies an input whose data does
not start on 16 bytes (the kernel stages whole 16-byte pieces), allocates
outputs with ``torch.empty``, launches on the current stream and raises on
a launch error.  There is no fallback from the card to the twin.  The
kernel is built for the head dims of ``HEAD_DIMS``; any other raises.
``chunk`` is the reference's TPU chunk length, accepted and unused: the
kernel walks the timesteps in a loop and takes any ``S >= 1``.

The kernel is forward only, as the reference's is: where autograd would
record (grad enabled and an input that requires a gradient) the wrapper
raises, on the CPU and the card alike (``_build.refuse_grad``).

``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ref

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128)   # the kernel's instantiations

LAUNCHES: Dict[str, int] = {"wkv6_bh": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("wkv6", {
    "wkv6_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I],
}, "wkv6_error_string", LAUNCHES)
reset_launches = _LIB.reset


def check_dtypes(r, k, v, w, u) -> torch.dtype:
    """r, k, v in one compute dtype (f32 or bf16), w and u in f32."""
    dt = _build.compute_dtype("wkv6 r", r)
    if k.dtype != dt or v.dtype != dt:
        raise TypeError(f"wkv6: r, k, v must share one dtype, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv6: w and u must be float32 (the model's decay "
                        f"is f32), got {w.dtype}, {u.dtype}")
    return dt


def wkv6_bh(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, *, chunk: int = 256):
    """r, k, v, w: (BH, S, D); u: (BH, D).  Returns (y (BH, S, D) in r's
    dtype, S_final (BH, D, D) f32)."""
    del chunk
    if r.dim() != 3 or any(tuple(a.shape) != tuple(r.shape)
                           for a in (k, v, w)):
        raise ValueError(f"wkv6_bh: expected r, k, v, w of one (BH, S, D) "
                         f"shape, got {[tuple(a.shape) for a in (r, k, v, w)]}")
    _build.refuse_grad("wkv6_bh", r, k, v, w, u)
    bh, s, d = r.shape
    if tuple(u.shape) != (bh, d) or s < 1:
        raise ValueError(f"wkv6_bh: expected u {(bh, d)} and S >= 1, got "
                         f"{tuple(u.shape)}, S={s}")
    dt = check_dtypes(r, k, v, w, u)
    if _build.on_cpu(r, k, v, w, u):
        return ref.wkv6_bh_ref(r, k, v, w, u)
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv6_bh: head dim {d} not in {HEAD_DIMS}, the "
                         f"head dims the CUDA kernel is built for")
    for name, a in (("r", r), ("k", k), ("v", v)):
        _build.check(name, a, (bh, s, d), dt)
    _build.check("w", w, (bh, s, d))
    _build.check("u", u, (bh, d))
    r, k, v, w, u = (a if a.data_ptr() % 16 == 0 else a.clone()
                     for a in (r, k, v, w, u))
    y = torch.empty_like(r)
    sfin = torch.empty((bh, d, d), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        _LIB.launch("wkv6_bh", "wkv6_fwd", r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
                    sfin.data_ptr(), bh, s, d, int(dt == torch.bfloat16))
    return y, sfin
