"""RWKV6 "Finch" time-mix + channel-mix [arXiv:2404.05892]
(``repro/models/rwkv6.py``).

Data-dependent decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)) per key
channel, per step; token-shift interpolation with static per-channel
mixes.  The WKV recurrence per head (state S in R^{DxD}):

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Full-sequence mode takes one of two paths (``module.einsum_path``):

- inference on plain tensors: the WKV6 wrapper (``repro_torch.kernels.wkv6``) for
  ``wkv_impl="xla"`` and ``"wkv6_kernel"`` alike.  On a CUDA tensor it
  launches the CUDA kernel, on a CPU tensor it runs the kernel's twin
  (``kernels/wkv6/ref.py``).  w reaches it in f32 whatever the compute
  dtype, as ``_decay`` returns it;
- training, and any ``DTensor`` input (the dry run, sharded ranks): the
  reference's ``wkv_scan`` (its ``wkv_impl="xla"``), a loop over time in
  f32 in plain torch.  The kernel has no backward, nor has the
  reference's, and it takes no DTensor, so ``wkv_impl="wkv6_kernel"``
  raises there.

Decode carries (shift_t, shift_c, S) and stays plain torch, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import layers as L
from repro_torch.models import module as m
from repro_torch.sharding import apply as sh
from repro_torch.utils.op_stats import recurrence

DECAY_RANK = 64

WKV_IMPLS = ("xla", "wkv6_kernel")   # both name the kernel in inference


def init_time_mix(gen, cfg: ModelConfig, device=None):
    pdt = m.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "mu": m.uniform(gen, (5, d), device) * 0.5 + 0.25,
        "w_r": m.dense_init(gen, d, d, device, dtype=pdt),
        "w_k": m.dense_init(gen, d, d, device, dtype=pdt),
        "w_v": m.dense_init(gen, d, d, device, dtype=pdt),
        "w_g": m.dense_init(gen, d, d, device, dtype=pdt),
        "w_o": m.dense_init(gen, d, d, device, dtype=pdt),
        "decay_a": m.dense_init(gen, d, DECAY_RANK, device, scale=0.01,
                                dtype=pdt),
        "decay_b": m.dense_init(gen, DECAY_RANK, d, device, scale=0.01,
                                dtype=pdt),
        "decay_w0": m.linspace(-6.0, -1.0, d, device),
        "bonus_u": m.zeros((d,), device),
        "ln_scale": m.ones((d,), device),      # per-head groupnorm scale
    }


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decay_local(xw, a, b, w0):
    dt = xw.dtype
    lo = torch.tanh(xw @ a.to(dt)) @ b.to(dt)
    return torch.exp(-torch.exp(w0 + lo.to(torch.float32)))


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0,1), f32.  xw: (..., d) mixed input,
    batch first.  On DTensors each rank runs its batch shard with the
    small low-rank pair gathered whole (``sharding.apply.split_map``):
    DTensor's own propagation splits the rank dim over the idle model
    axis, and on the multi-pod mesh the backward of that layout fails in
    its sharding propagation."""
    return sh.split_map(_decay_local, (xw, params["decay_a"],
                                       params["decay_b"],
                                       params["decay_w0"]),
                        [(0, None)] + [(None, None)] * 3, [(0, None)])


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int,
                eps: float = 64e-5):
    """Per-head groupnorm over head_dim.  y: (..., d)."""
    shp = y.shape
    yh = sh.reshape(y, *shp[:-1], H, shp[-1] // H).to(torch.float32)
    mean = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return (sh.reshape(yh, shp) * scale).to(y.dtype)


def _wkv_inputs(params, cfg: ModelConfig, x: torch.Tensor, xx: torch.Tensor):
    """Project mixed inputs to per-head r,k,v,w,g.  x, xx: (B, S, d)."""
    dt = x.dtype
    mu = params["mu"]
    r = _mix(x, xx, mu[0]) @ params["w_r"].to(dt)
    k = _mix(x, xx, mu[1]) @ params["w_k"].to(dt)
    v = _mix(x, xx, mu[2]) @ params["w_v"].to(dt)
    g = _mix(x, xx, mu[3]) @ params["w_g"].to(dt)
    w = _decay(params, _mix(x, xx, mu[4]))
    return r, k, v, w, g


def _shift_local(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: x[:, t-1], zeros at t = 0.  x: (B, S, d).  On DTensors
    each rank shifts its batch shard (torch 2.11's DTensor cannot pad a
    dim that two mesh axes split)."""
    return sh.split_map(_shift_local, (x,), [(0, None)], [(0, None)])


def wkv_scan(r, k, v, w, u, S0):
    """The reference's WKV recurrence, differentiable.  r, k, v, w:
    (B, S, H, D); u: (H, D); S0: (B, H, D, D).  Returns (y (B, S, H, D)
    f32, S_final), a loop over t in f32 as the reference's ``lax.scan``.
    The steps are taken apart by one ``unbind`` a tensor, whose backward is
    one ``stack``: indexing step t would make a zero-filled (B, S, H, D)
    gradient for every step, S² work in all."""
    rf, kf, vf, wf = (a.to(torch.float32).unbind(1) for a in (r, k, v, w))
    S = S0
    ys = []
    for rt, kt, vt, wt in zip(rf, kf, vf, wf):
        kv = kt[:, :, :, None] * vt[:, :, None, :]                 # (B,H,D,D)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u[..., :, None] * kv))
        S = wt[:, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


# the scan as the dry run counts it (``utils.op_stats.recurrence``): two
# short lengths extended in S; elsewhere ``wkv_scan`` itself
WKV_SCAN = recurrence(wkv_scan, time_args=(0, 1, 2, 3), time_outs=(0,))


def time_mix_full(params, cfg: ModelConfig, x: torch.Tensor,
                  impl: str = "xla") -> torch.Tensor:
    """Full-sequence time-mix.  x: (B, S, d)."""
    if impl not in WKV_IMPLS:
        raise ValueError(f"wkv_impl must be one of {WKV_IMPLS}, got "
                         f"{impl!r}")
    B, S, d = x.shape
    D = cfg.head_dim
    H = d // D
    r, k, v, w, g = _wkv_inputs(params, cfg, x, _shift(x))
    rh, kh, vh, wh = (sh.reshape(a, B, S, H, D) for a in (r, k, v, w))
    u = params["bonus_u"].reshape(H, D)
    if not m.einsum_path(rh, kh, vh, wh, u):
        y, _ = wkv_ops.wkv6(rh, kh, vh, wh, u, None)
    elif impl == "wkv6_kernel":
        raise NotImplementedError(
            "wkv_impl='wkv6_kernel' under autograd or on DTensors: the WKV6 "
            "kernel has no backward, nor has the reference's, and it takes "
            "no DTensor; train and shard with wkv_impl='xla'")
    else:
        S0 = torch.zeros((B, H, D, D), dtype=torch.float32, device=x.device)
        # independent along the batch and the heads (on DTensors each
        # rank runs its shards)
        y, _ = sh.split_map(WKV_SCAN, (rh, kh, vh, wh, u, S0),
                            [(0, 2)] * 4 + [(None, 0), (0, 1)],
                            [(0, 2), (0, 1)])
    y = sh.reshape(y, B, S, d).to(x.dtype)
    y = _group_norm(y, params["ln_scale"], H)
    return (y * L.silu(g)) @ params["w_o"].to(x.dtype)


def init_channel_mix(gen, cfg: ModelConfig, device=None):
    pdt = m.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "mu": m.uniform(gen, (2, d), device) * 0.5 + 0.25,
        "w_k": m.dense_init(gen, d, cfg.d_ff, device, dtype=pdt),
        "w_v": m.dense_init(gen, cfg.d_ff, d, device, dtype=pdt),
        "w_r": m.dense_init(gen, d, d, device, dtype=pdt),
    }


def channel_mix_full(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xx = _shift(x)
    k = _mix(x, xx, params["mu"][0]) @ params["w_k"].to(dt)
    r = _mix(x, xx, params["mu"][1]) @ params["w_r"].to(dt)
    v = torch.square(torch.relu(k)) @ params["w_v"].to(dt)
    return L.sigmoid(r) * v


# ---------------------------------------------------------------------------
# decode (single token, carried state)
# ---------------------------------------------------------------------------

def init_rwkv_state(cfg: ModelConfig, batch: int, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    D = cfg.head_dim
    H = cfg.d_model // D
    return {
        "shift_t": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "wkv": torch.zeros((batch, H, D, D), dtype=torch.float32,
                           device=device),
    }


def _wkv_step(r, k, v, w, u, S):
    """One WKV step: r, k, v, w (B, H, D) f32; S (B, H, D, D)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r, S + u[..., :, None] * kv)
    return y, w[..., :, None] * S + kv


def time_mix_decode(params, cfg: ModelConfig, x: torch.Tensor,
                    state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d)."""
    B, _, d = x.shape
    D = cfg.head_dim
    H = d // D
    x1 = x[:, 0]
    xx = state["shift_t"]
    r, k, v, w, g = _wkv_inputs(params, cfg, x1, xx)
    rh, kh, vh, wh = (sh.reshape(a, B, H, D).to(torch.float32)
                      for a in (r, k, v, w))
    u = params["bonus_u"].reshape(H, D)
    y, S = sh.split_map(_wkv_step, (rh, kh, vh, wh, u, state["wkv"]),
                        [(0, 1)] * 4 + [(None, 0), (0, 1)],
                        [(0, 1), (0, 1)], ref=5)
    y = _group_norm(sh.reshape(y, B, d).to(x.dtype), params["ln_scale"], H)
    out = (y * L.silu(g)) @ params["w_o"].to(x.dtype)
    new_state = dict(state, shift_t=x1, wkv=S)
    return out[:, None], new_state


def channel_mix_decode(params, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    dt = x.dtype
    x1 = x[:, 0]
    xx = state["shift_c"]
    k = _mix(x1, xx, params["mu"][0]) @ params["w_k"].to(dt)
    r = _mix(x1, xx, params["mu"][1]) @ params["w_r"].to(dt)
    v = torch.square(torch.relu(k)) @ params["w_v"].to(dt)
    out = L.sigmoid(r) * v
    return out[:, None], dict(state, shift_c=x1)
