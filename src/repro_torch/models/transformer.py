"""The scanned-transformer spine for the dense and ssm families
(``repro/models/transformer.py``).

  dense       : norm -> GQA attention -> res ; norm -> SwiGLU -> res
  ssm (rwkv6) : norm -> WKV6 time-mix -> res ; norm -> channel-mix -> res

Per-layer weights are stacked on a leading (L, ...) axis, the reference's
layout; its ``lax.scan`` over layers is a Python loop over ``[i]`` here.
The families moe, hybrid, vlm and audio are not ported yet (ROADMAP.md,
queue 1) and raise ``NotImplementedError``.  ``opts`` takes the
reference's keys:
  impl          'xla' | 'flash'       (both: the flash-attention kernel)
  wkv_impl      'xla' | 'wkv6_kernel' (both: the WKV6 kernel)
  moe_dispatch  accepted (no moe family here)
  remat         'none' only (training is not ported yet)
  act_sharding, unroll_layers: accepted, no effect (one device, eager)
  return_hidden forward_full returns the final-normed hidden states
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import module as m
from repro_torch.models import rwkv6 as rk
from repro_torch.models.rope import text_positions
from repro_torch.utils.tree import tree_map

DEFAULT_OPTS = {"impl": "xla", "wkv_impl": "xla",
                "moe_dispatch": "scatter", "remat": "none",
                "act_sharding": None, "unroll_layers": False}

PORTED_FAMILIES = ("dense", "ssm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family whose layers are not ported yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ported: {PORTED_FAMILIES}); see ROADMAP.md, queue 1")


def _opts(opts: Optional[dict]) -> dict:
    unknown = set(opts or {}) - set(DEFAULT_OPTS) - {"return_hidden"}
    if unknown:
        raise ValueError(f"unknown opts {sorted(unknown)}")
    opts = {**DEFAULT_OPTS, **(opts or {})}
    if opts["remat"] != "none":
        raise NotImplementedError(
            f"remat={opts['remat']!r}: rematerialisation is for training, "
            "which is not ported yet (ROADMAP.md, queue 1)")
    return opts


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "norm1": L.init_rmsnorm(cfg.d_model, device),
        "norm2": L.init_rmsnorm(cfg.d_model, device),
    }
    if cfg.family == "ssm":
        p["time"] = rk.init_time_mix(gen, cfg, device)
        p["channel"] = rk.init_channel_mix(gen, cfg, device)
        return p
    p["attn"] = attn.init_attention(gen, cfg, device)
    p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> Dict[str, Any]:
    """Random params from ``gen`` (drawn on its device), on ``device``."""
    check_family(cfg)
    params: Dict[str, Any] = {"embed": L.init_embedding(gen, cfg, device)}
    params["layers"] = m.stack_layers(
        lambda g: _init_layer(g, cfg, device), gen, cfg.num_layers)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device)
    params["head"] = L.init_lm_head(gen, cfg, device)
    return params


def layer(params, i: int) -> Dict[str, Any]:
    """Layer i's params from the stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], params["layers"])


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _layer_full(p, cfg: ModelConfig, x: torch.Tensor, positions, opts):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        x = x + rk.time_mix_full(p["time"], cfg, h, impl=opts["wkv_impl"])
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        return x + rk.channel_mix_full(p["channel"], cfg, h)
    x = x + attn.attend_full(p["attn"], cfg, h, positions, impl=opts["impl"])
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h)


def forward_full(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                 opts: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, vocab_padded), aux scalar 0), or the hidden
    states (B, S, d) in place of the logits with ``return_hidden``."""
    check_family(cfg)
    opts = _opts(opts)
    dtype = m.dtype_of(cfg.dtype)
    x = L.embed(params["embed"], inputs["tokens"], dtype)
    B, S = x.shape[:2]
    positions = inputs.get("positions")
    if positions is None:
        positions = text_positions(B, S, mrope=bool(cfg.mrope_sections),
                                   device=x.device)
    for i in range(cfg.num_layers):
        x = _layer_full(layer(params, i), cfg, x, positions, opts)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if opts.get("return_hidden"):
        return x, aux
    return L.lm_logits(params["head"], params.get("embed"), cfg, x), aux


# ---------------------------------------------------------------------------
# decode (single new token against carried per-layer state)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, context_len: int,
                      dtype, device=None) -> Dict[str, Any]:
    """Stacked (L, ...) per-layer state: the KV ring-buffer cache (dense)
    or the RWKV token shifts and WKV state (ssm)."""
    check_family(cfg)
    Lr = cfg.num_layers
    rep = lambda tree: tree_map(
        lambda a: a[None].expand((Lr,) + tuple(a.shape)).clone(), tree)
    if cfg.family == "ssm":
        return {"rwkv": rep(rk.init_rwkv_state(cfg, batch, dtype, device))}
    return {"kv": rep(attn.init_cache(cfg, batch, context_len, dtype,
                                      device))}


def _layer_decode(p, cfg: ModelConfig, x, state, position):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        y, rst = rk.time_mix_decode(p["time"], cfg, h, state["rwkv"])
        x = x + y
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, rst = rk.channel_mix_decode(p["channel"], cfg, h, rst)
        return x + y, {"rwkv": rst}
    y, kv = attn.attend_decode(p["attn"], cfg, h, state["kv"], position)
    x = x + y
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h), {"kv": kv}


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                state: Dict[str, Any], position: torch.Tensor,
                opts: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B, 1) int; position: (B,) absolute index of the new token.
    Returns (logits (B, 1, vocab_padded), new_state)."""
    check_family(cfg)
    _opts(opts)
    dtype = m.dtype_of(cfg.dtype)
    x = L.embed(params["embed"], token, dtype)
    new_states = []
    for i in range(cfg.num_layers):
        st = tree_map(lambda a: a[i], state)
        x, st = _layer_decode(layer(params, i), cfg, x, st, position)
        new_states.append(st)
    new_state = tree_map(lambda *ls: torch.stack(ls), *new_states)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(params["head"], params.get("embed"), cfg, x), new_state
