"""Mamba selective-SSM branch of the Hymba hybrid block
(``repro/models/mamba.py``).

Selective scan (Mamba-1 style):  h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t,
y_t = C_t . h_t + D x_t,  with input-dependent (dt, B, C) and a causal
depthwise conv front.  The full-sequence scan is a loop over time with an
f32 state (B, d_inner, N), as the reference's ``lax.scan``; it runs in plain
torch (the reference has no kernel for it).  Decode carries
``(conv_state, ssm_state)``.

Activations follow XLA's lowering op by op, so that bf16 values round as
the reference's do: ``softplus`` is ``max(x, 0) + log1p(exp(-|x|))`` with
no threshold branch (``torch.nn.functional.softplus`` has one at 20), and
``silu`` is ``layers.silu``.  The causal conv sums its taps in the
reference's order.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import module as m
from repro_torch.sharding import apply as sh
from repro_torch.utils.op_stats import recurrence

# time steps whose decays and inputs are formed at once in the scan: a
# bound on its scratch (B x SCAN_CHUNK x d_inner x N f32, three buffers)
SCAN_CHUNK = 128


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) op by op, each step
    rounded to x's dtype."""
    out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def init_mamba(gen, cfg: ModelConfig, device=None):
    pdt = m.dtype_of(cfg.param_dtype)
    di, N, R = cfg.d_inner, cfg.ssm_state, dt_rank(cfg)
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device).repeat(di, 1)
    return {
        "w_in": m.dense_init(gen, cfg.d_model, 2 * di, device, dtype=pdt),
        "conv_w": m.normal(gen, (cfg.ssm_conv, di), 0.1, device, pdt),
        "w_xproj": m.dense_init(gen, di, R + 2 * N, device, dtype=pdt),
        "w_dt": m.dense_init(gen, R, di, device, dtype=pdt),
        "log_A": torch.log(A),                  # keeps A negative: -exp(log_A)
        "D": m.ones((di,), device),
        "w_out": m.dense_init(gen, di, cfg.d_model, device, dtype=pdt),
    }


def _split_proj(params, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (..., di) post-conv activations -> (dt (.., di), B (.., N),
    C (.., N)), all f32."""
    N, R = cfg.ssm_state, dt_rank(cfg)
    # on DTensors the product over di (split over the model axis) is a
    # partial sum: done here, as GSPMD does it
    proj = sh.settle(xc @ params["w_xproj"].to(xc.dtype))
    dtr, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = softplus(dtr @ params["w_dt"].to(xc.dtype)).to(torch.float32)
    return dt, Bm.to(torch.float32), Cm.to(torch.float32)


def _causal_conv(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, di); taps summed in order."""
    K = params["conv_w"].shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    w = params["conv_w"].to(x.dtype)
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return L.silu(out)


def selective_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   xf: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The scan over time from a zero state, all f32: dt, xf (B, S, di);
    Bm, Cm (B, S, N); A (di, N).  Returns y (B, S, di), y_t = C_t . h_t.

    Each step is the reference's ``h = decay * h + (dt x)[..., None] * B``
    (a product, then a sum); the decays and inputs of SCAN_CHUNK steps are
    formed together, and their states contracted with C together.  In
    inference the states are written into one buffer (``out=``, in place);
    where autograd records, which does not allow it, and on DTensors, each
    step makes a new tensor and the chunk's states are stacked: the same
    two roundings a step, so the two forms agree bit for bit."""
    B_, S, di = xf.shape
    train = m.einsum_path(dt, Bm, Cm, xf, A)
    h = torch.zeros((B_, di, A.shape[1]), dtype=torch.float32,
                    device=xf.device)
    ys = []
    # one split a tensor and one unbind a chunk, whose backwards are one
    # cat and one stack: slicing a chunk and indexing a step would make a
    # zero-filled gradient of the whole for every one, S² work in all
    for dtc, xc, Bc, Cc in zip(*(a.split(SCAN_CHUNK, dim=1)
                                 for a in (dt, xf, Bm, Cm))):
        decay = torch.exp(dtc[..., None] * A)                 # (B,c,di,N)
        inp = (dtc * xc)[..., None] * Bc[:, :, None, :]
        if train:
            states = []
            for dj, ij in zip(decay.unbind(1), inp.unbind(1)):
                h = dj * h + ij
                states.append(h)
            hs = torch.stack(states, dim=1)
        else:
            hs = torch.empty_like(decay)
            for j in range(decay.shape[1]):
                torch.mul(decay[:, j], h, out=hs[:, j])
                h = hs[:, j].add_(inp[:, j])
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cc))
    return torch.cat(ys, dim=1)


def _gated_scan(out_dtype, dt, Bm, Cm, xf, A, D, z):
    """The scan, its skip term and the output gate: (B, S, di)."""
    y = selective_scan(dt, Bm, Cm, xf, A) + xf * D
    return y.to(out_dtype) * L.silu(z)


# the scan as the dry run counts it (``utils.op_stats.recurrence``): short
# lengths extended in S, the chunks' own cost included; elsewhere
# ``_gated_scan`` itself
GATED_SCAN = recurrence(_gated_scan, time_args=(1, 2, 3, 4, 7),
                        time_outs=(0,), period=SCAN_CHUNK)


def mamba_full(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence selective scan.  x: (B, S, d) -> (B, S, d).  The conv
    and the scan are independent along the batch and the channels: on
    DTensors each rank runs its shards (``sharding.apply.split_map``)."""
    dt_ = x.dtype
    di = cfg.d_inner
    xz = x @ params["w_in"].to(dt_)
    xs, z = xz[..., :di], xz[..., di:]
    xc = sh.split_map(lambda a, w: _causal_conv({"conv_w": w}, a),
                      (xs, params["conv_w"]), [(0, 2), (None, 1)], [(0, 2)])
    dt, Bm, Cm = _split_proj(params, cfg, xc)                 # (B,S,di) (B,S,N)
    A = -torch.exp(params["log_A"])                           # (di, N)
    xf = xc.to(torch.float32)
    y = sh.split_map(functools.partial(GATED_SCAN, dt_),
                     (dt, Bm, Cm, xf, A, params["D"], z),
                     [(0, 2), (0, None), (0, None), (0, 2), (None, 0),
                      (None, 0), (0, 2)], [(0, 2)], ref=3)
    return y @ params["w_out"].to(dt_)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: (B, 1, d)."""
    dt_ = x.dtype
    di = cfg.d_inner
    xz = x[:, 0] @ params["w_in"].to(dt_)
    xs, z = xz[..., :di], xz[..., di:]
    window = torch.cat([state["conv"], xs[:, None]], dim=1)   # (B, K, di)
    w = params["conv_w"].to(dt_)
    xc = L.silu(torch.einsum("bkd,kd->bd", window, w))
    dt, Bm, Cm = _split_proj(params, cfg, xc)
    A = -torch.exp(params["log_A"])
    decay = torch.exp(dt[..., None] * A)
    xcf = xc.to(torch.float32)
    h = decay * state["ssm"] + (dt * xcf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + xcf * params["D"]
    y = (y.to(dt_) * L.silu(z)) @ params["w_out"].to(dt_)
    return y[:, None], {"conv": window[:, 1:], "ssm": h}
