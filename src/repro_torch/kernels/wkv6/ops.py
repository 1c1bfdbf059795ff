"""(B, S, H, D) layout -> kernel layout (``repro/kernels/wkv6/ops.py``).

The kernel owns the state's initialisation (zeros), so ``S0`` must be
None: a given initial state raises.  (The reference's wrapper takes an S0
argument and ignores it.)
"""
from __future__ import annotations

from repro_torch.kernels.wkv6.kernel import wkv6_bh


def wkv6(r, k, v, w, u, S0=None, chunk: int = 256):
    """r, k, v, w: (B, S, H, D); u: (H, D).  Returns (y (B, S, H, D) in r's
    dtype, S_final (B, H, D, D) f32)."""
    if S0 is not None:
        raise ValueError("wkv6: the kernel starts from a zero state; S0 "
                         "must be None (a given initial state is not "
                         "supported)")
    B, S, H, D = r.shape
    fold = lambda a: a.transpose(1, 2).reshape(B * H, S, D).contiguous()
    uf = u[None].expand(B, H, D).reshape(B * H, D).contiguous()
    y, sf = wkv6_bh(fold(r), fold(k), fold(v), fold(w), uf, chunk=chunk)
    return (y.reshape(B, H, S, D).transpose(1, 2),
            sf.reshape(B, H, D, D))
