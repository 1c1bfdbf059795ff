"""Wrappers of the mixture-of-experts dispatch and combine CUDA kernels
(``csrc/moe_dispatch.cu``).

They replace no TPU kernel: the JAX package does this in ``jnp``.  Three
functions of the scatter path of ``models/moe.py``, for ``T`` tokens
routed to ``k`` of ``E`` experts with ``C`` slots each:

- ``moe_slots(flat_e, E, C)``: the routes' experts ``(T·k,)`` int64,
  token-major -> ``slot`` (T·k,) int64, ``keep`` (T·k,) bool and the
  routes per expert ``counts`` (E,) int32.  A route's place in its expert
  is the count of earlier routes to it; past C it is dropped (slot E·C);
- ``moe_scatter(x2d, slot, counts, E, C, k)``: the (E, C, d) expert
  buffer, each kept route's token row in its slot and zeros elsewhere;
- ``moe_combine(expert_out, slot, flat_w, k)``: (T, d), each token's
  kept expert rows weighted (each product rounded to the dtype of
  ``expert_out``), summed in f32 in route order and rounded once.

Each gives the bits of its plain code in ``ref.py`` (``slots_ref`` and
``scatter_ref``, which ``models/moe.py`` runs where autograd records and
on DTensors; ``combine_ref``, the combine's twin).  On CPU tensors a
wrapper runs that code; on CUDA tensors it checks dtype, shape,
contiguity and alignment, allocates its outputs with ``torch.empty``,
launches on the current stream and raises on a launch error.  There is no fallback from the card to the twin.  The
rows move as 16-byte vectors, so d must be a multiple of 8, and the
dtype f32 or bf16; anything else raises, on the CPU as on the card.  The
kernels are forward only: where autograd would record, the wrappers raise
(``_build.refuse_grad``).

``LAUNCHES`` counts the wrapper calls on the card; ``moe_slots`` launches
three ``__global__`` functions a call, the other two one.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch import ref

CHUNK = 512          # routes one warp ranks in order (kChunk of the source)
MAX_EXPERTS = 1024   # experts the slot kernels' shared memory holds

LAUNCHES: Dict[str, int] = {"moe_slots": 0, "moe_scatter": 0,
                            "moe_combine": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = _build.Library("moe_dispatch", {
    "moe_slots": [_P, _P, _P, _P, _P, _L, _I, _I],
    "moe_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    "moe_combine": [_P, _P, _P, _P, _I, _I, _L, _I, _I],
}, "moe_error_string", LAUNCHES)
reset_launches = _LIB.reset


def _rows(name: str, t: torch.Tensor) -> int:
    """The row width of ``t`` (..., d), after the checks every wrapper
    makes: f32 or bf16, d a multiple of 8."""
    _build.compute_dtype(name, t)
    d = t.shape[-1]
    if d % 8:
        raise ValueError(f"{name}: the row width must be a multiple of 8 "
                         f"(16-byte vectors), got {d}")
    return d


def _experts(E: int, C: int) -> None:
    if not 1 <= E <= MAX_EXPERTS or C < 1:
        raise ValueError(f"moe dispatch: need 1 <= E <= {MAX_EXPERTS} and "
                         f"C >= 1, got E={E}, C={C}")


def moe_slots(flat_e: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flat_e (N,) int64 -> (slot (N,) int64, keep (N,) bool, counts (E,)
    int32)."""
    if flat_e.dim() != 1 or flat_e.dtype != torch.int64:
        raise ValueError(f"moe_slots: expected (N,) int64 experts, got "
                         f"{tuple(flat_e.shape)} {flat_e.dtype}")
    _experts(E, C)
    if _build.on_cpu(flat_e):
        return ref.slots_ref(flat_e, E, C)
    n = flat_e.shape[0]
    _build.check("flat_e", flat_e, (n,), torch.int64)
    dev = flat_e.device
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    keep = torch.empty((n,), dtype=torch.bool, device=dev)
    counts = torch.empty((E,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, math.ceil(n / CHUNK)) * E,),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _LIB.launch("moe_slots", "moe_slots", flat_e.data_ptr(),
                    slot.data_ptr(), keep.data_ptr(), counts.data_ptr(),
                    scratch.data_ptr(), n, E, C)
    return slot, keep, counts


def moe_scatter(x2d: torch.Tensor, slot: torch.Tensor, counts: torch.Tensor,
                E: int, C: int, k: int) -> torch.Tensor:
    """x2d (T, d), slot (T·k,) int64, counts (E,) int32 -> (E, C, d) in
    x's dtype."""
    if x2d.dim() != 2:
        raise ValueError(f"moe_scatter: expected x (T, d), got "
                         f"{tuple(x2d.shape)}")
    T, _ = x2d.shape
    d = _rows("moe_scatter x", x2d)
    _experts(E, C)
    _build.refuse_grad("moe_scatter", x2d)
    if _build.on_cpu(x2d, slot, counts):
        return ref.scatter_ref(x2d, slot, E, C, k)
    _build.check("x", x2d, (T, d), x2d.dtype, align=16)
    _build.check("slot", slot, (T * k,), torch.int64)
    _build.check("counts", counts, (E,), torch.int32)
    buf = torch.empty((E, C, d), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        _LIB.launch("moe_scatter", "moe_scatter", x2d.data_ptr(),
                    slot.data_ptr(), counts.data_ptr(), buf.data_ptr(), T, k,
                    E, C, d * x2d.element_size())
    return buf


def moe_combine(expert_out: torch.Tensor, slot: torch.Tensor,
                flat_w: torch.Tensor, k: int) -> torch.Tensor:
    """expert_out (E, C, d), slot (T·k,) int64, flat_w (T·k,) in
    expert_out's dtype -> (T, d)."""
    if expert_out.dim() != 3 or slot.dim() != 1 or slot.shape[0] % k:
        raise ValueError(f"moe_combine: expected out (E, C, d) and slot "
                         f"(T·k,), got {tuple(expert_out.shape)}, "
                         f"{tuple(slot.shape)} with k={k}")
    E, C, _ = expert_out.shape
    d = _rows("moe_combine out", expert_out)
    dt = expert_out.dtype
    if flat_w.dtype != dt or tuple(flat_w.shape) != tuple(slot.shape):
        raise TypeError(f"moe_combine: weights must be (T·k,) in the "
                        f"outputs' dtype {dt}, got {tuple(flat_w.shape)} "
                        f"{flat_w.dtype}")
    _build.refuse_grad("moe_combine", expert_out, flat_w)
    if _build.on_cpu(expert_out, slot, flat_w):
        return ref.combine_ref(expert_out, slot, flat_w, k)
    T = slot.shape[0] // k
    _build.check("out", expert_out, (E, C, d), dt, align=16)
    _build.check("slot", slot, (T * k,), torch.int64)
    _build.check("w", flat_w, (T * k,), dt)
    y = torch.empty((T, d), dtype=dt, device=expert_out.device)
    with torch.cuda.device(expert_out.device):
        _LIB.launch("moe_combine", "moe_combine", expert_out.data_ptr(),
                    slot.data_ptr(), flat_w.data_ptr(), y.data_ptr(), T, k,
                    E * C, d, int(dt == torch.bfloat16))
    return y
