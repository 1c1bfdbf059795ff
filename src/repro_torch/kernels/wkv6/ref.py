"""Plain PyTorch twin of the WKV6 kernel (``repro/kernels/wkv6``), and the
reference's scan (``repro/models/rwkv6.py`` ``wkv_scan``).

The recurrence per head, state S in R^{DxD}::

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Every input is widened to f32 and the state is f32.  The kernel wrapper
runs ``wkv6_bh_ref`` on CPU tensors; the tests and ``chip_smoke.py`` hold
the CUDA kernel to it on the card.
"""
from __future__ import annotations

import torch


def wkv_scan(r, k, v, w, u, S0):
    """r, k, v, w: (B, S, H, D); u: (H, D); S0: (B, H, D, D) f32.
    Returns (y (B, S, H, D) f32, S_final (B, H, D, D) f32): a loop over t
    in f32, as the reference's ``lax.scan``."""
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    uf = u.to(torch.float32)
    S = S0.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B,H,D,D)
        y = torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf[..., :, None] * kv)
        S = wf[:, t, :, :, None] * S + kv
        ys.append(y)
    return torch.stack(ys, dim=1), S


def wkv6_bh_ref(r, k, v, w, u):
    """The kernel's function on its folded layout: r, k, v, w (BH, S, D),
    u (BH, D), zero initial state.  Returns (y (BH, S, D) in r's dtype,
    S_final (BH, D, D) f32)."""
    BH, _, D = r.shape
    S0 = torch.zeros((BH, 1, D, D), dtype=torch.float32, device=r.device)
    y, S = wkv_scan(*(a[:, :, None] for a in (r, k, v, w)), u[:, None], S0)
    return y[:, :, 0].to(r.dtype), S[:, 0]
