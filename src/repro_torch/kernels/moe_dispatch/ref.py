"""The plain PyTorch code of the mixture-of-experts scatter path's
dispatch, and the twin of the combine kernel (``csrc/moe_dispatch.cu``).

``slots_ref`` and ``scatter_ref`` are the one plain implementation of the
slots and the expert buffer: ``models/moe.py`` runs them where autograd
records and on DTensors' gathered replicas, and the wrappers of
``kernel.py`` run them on CPU tensors.  The tests and ``chip_smoke.py``
hold the CUDA kernels to them bit for bit on the card.

- ``slots_ref``: a route's place in its expert is the count of earlier
  routes to that expert, an exclusive cumsum of one-hots in token-major
  order; past the capacity C it goes to the waste row E·C.  The one-hots
  are laid out expert-major, so that the cumsum runs along rows: on the
  card a scan down the (T·k, E) columns took 6.4 ms a layer at T·k =
  32768.  The routes per expert are the one-hots' row sums;
- ``scatter_ref``: each token repeated k times, copied into its routes'
  rows of a zeroed (E·C + 1, d) buffer whose waste row is cut off (no
  shape depends on the data, so it runs on fake tensors too);
- ``combine_ref`` multiplies each kept row by its weight in the outputs'
  dtype (an exact f32 product of two bf16 values rounded once to bf16, as
  the plain path ``models.moe._combine`` and the reference round it; at
  f32 the kernel's ``__fmul_rn``), sums a token's products in f32 a route
  at a time in route order (``__fadd_rn``) and rounds the sum once to the
  dtype: the kernel's bits.  ``_combine`` sums in another order, so the
  two differ by the f32 sums' reordering and one rounding of the output.
"""
from __future__ import annotations

from typing import Tuple

import torch


def slots_ref(flat_e: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flat_e (N,) int64, token-major -> (slot (N,) int64, keep (N,) bool,
    counts (E,) int32)."""
    onehot = torch.nn.functional.one_hot(flat_e, E).T.contiguous()  # (E, N)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot            # exclusive
    pos = torch.gather(pos_in_e, 0, flat_e[None])[0]
    keep = pos < C                                            # capacity drop
    slot = torch.where(keep, flat_e * C + pos, E * C)         # waste slot
    return slot, keep, onehot.sum(dim=1).to(torch.int32)


def scatter_ref(x2d: torch.Tensor, slot: torch.Tensor, E: int, C: int,
                k: int) -> torch.Tensor:
    """x2d (T, d), slot (T·k,) -> (E, C, d): route r's token row r // k in
    its slot where kept, zeros elsewhere."""
    d = x2d.shape[1]
    src = torch.repeat_interleave(x2d, k, dim=0) if k > 1 else x2d
    # kept routes have distinct slots; only the waste row E*C takes
    # several writes, and it is thrown away
    buf = torch.zeros((E * C + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf.index_copy_(0, slot, src)
    return buf[:E * C].reshape(E, C, d)


def combine_ref(expert_out: torch.Tensor, slot: torch.Tensor,
                flat_w: torch.Tensor, k: int) -> torch.Tensor:
    """expert_out (E, C, d), slot (T·k,), flat_w (T·k,) -> (T, d)."""
    E, C, d = expert_out.shape
    flat = expert_out.reshape(E * C, d)
    s = slot.reshape(-1, k)
    w = flat_w.reshape(-1, k)
    acc = torch.zeros((s.shape[0], d), dtype=torch.float32,
                      device=expert_out.device)
    for j in range(k):
        kept = s[:, j] < E * C
        prod = w[:, j, None] * flat[torch.where(kept, s[:, j], 0)]
        acc = acc + torch.where(kept[:, None], prod.float(), 0.0)
    return acc.to(expert_out.dtype)
