"""(B, S, H, D) GQA layout -> kernel layout
(``repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bh


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  Returns (B, Sq, H, D).

    Heads are folded h-major into the batch dim, so that q row b·H + h
    reads kv row (b·H + h) // G = b·KV + h // G, and K/V are never repeated.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.transpose(1, 2).reshape(B * H, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, k.shape[1], D).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, v.shape[1], D).contiguous()
    out = flash_attention_bh(qf, kf, vf, group_size=G, causal=causal,
                             window=window)
    return out.reshape(B, H, Sq, D).transpose(1, 2)
