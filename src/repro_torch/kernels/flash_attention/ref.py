"""Plain PyTorch twin of the flash-attention kernel
(``repro/kernels/flash_attention``).

``flash_attention_bh_ref`` computes the function of ``_attn_kernel``
(``repro/kernels/flash_attention/kernel.py``) densely: every input widened
to f32, scores ``q·kᵀ`` times ``D**-0.5`` after the dot, masked entries set
to ``NEG_INF``, a softmax over the whole row in f32, ``p @ v`` in f32, and
the output cast to q's dtype.  It is not a copy of the online loop, so it
differs from the CUDA kernel only by summation order.  The kernel wrapper
runs it on CPU tensors; the tests and ``chip_smoke.py`` hold the kernel to
it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def live_mask(sq: int, sk: int, causal: bool, window: int,
              device=None) -> torch.Tensor:
    """(Sq, Sk) boolean mask, True = attend.  Query and key ends are
    aligned: query row r sits at absolute position r + (Sk - Sq)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_bh_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group_size: int = 1, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BKV, Sk, D) with BH = BKV·group_size; the kv
    row of q row ``bh`` is ``bh // group_size``.  Returns (BH, Sq, D) in
    q's dtype."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    kf = k.float().repeat_interleave(group_size, dim=0)
    vf = v.float().repeat_interleave(group_size, dim=0)
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * (d ** -0.5)
    s = torch.where(live_mask(sq, sk, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)
