"""The scanned-transformer spine for every family of the zoo
(``repro/models/transformer.py``).

  dense / vlm / audio : norm -> GQA attention -> res ; norm -> SwiGLU -> res
  moe                 : ... ; norm -> top-k MoE FFN -> res (aux summed)
  ssm (rwkv6)         : norm -> WKV6 time-mix -> res ; norm -> channel-mix -> res
  hybrid (hymba)      : norm -> (attention || mamba) branch-normed mean -> res ;
                        norm -> SwiGLU -> res

Per-layer weights are stacked on a leading (L, ...) axis, the reference's
layout; its ``lax.scan`` over layers is a Python loop over ``[i]`` here.
Inputs: ``tokens`` (B, S); audio with a stub frontend takes precomputed
frame embeddings ``embeds`` (B, S, d) and has no embedding table; vlm
writes ``patch_embeds`` (B, P, d) over the first P positions and takes
M-RoPE ``positions`` (B, 3, S).  ``opts`` takes the reference's keys:
  impl          'xla' | 'flash'       (inference on plain tensors: both the
                flash-attention kernel.  Under autograd, and on DTensors
                (the dry run, sharded ranks), 'xla' is the reference's
                einsum path and 'flash' raises: the kernel has no backward
                and takes no DTensor.  So a DTensor program is always the
                reference's impl='xla' program, as its dry run lowers)
  wkv_impl      'xla' | 'wkv6_kernel' (likewise: the WKV6 kernel, or under
                autograd and on DTensors ``wkv_scan`` for 'xla')
  moe_dispatch  'dense' selects moe_dense, anything else the scatter path
  remat         'none' | 'full' (each layer recomputed in the backward) |
                'dots' (each layer recomputed but for its weight products,
                the matmuls with no batch dims: ``aten.mm``/``addmm``
                outputs are kept, the attention ``bmm``s recomputed; the
                counterpart of ``dots_with_no_batch_dims_saveable``)
  act_sharding  the activation sharding map of ``sharding/apply.py`` or
                None: on DTensor activations the bodies ``constrain`` them
                where the reference does (after the embedding, q/k/v of
                ``_sdpa_chunked``, the attention output, the moe expert
                buffers, every layer's output) and at the residual after
                the mixer, where DTensor cannot infer what GSPMD does; on
                plain tensors, and for None, it does nothing
  unroll_layers accepted, no effect: the layers are a Python loop already
  fused_head    accepted and ignored here, as the reference's forward does:
                ``training.step.loss_fn`` reads it
  return_hidden forward_full returns the final-normed hidden states

Remat changes no value: the recomputed ops are the same ops on the same
inputs.

Spans (``utils.trace``, device spans on plain CUDA tensors):
``model.embed``, each layer's ``layer.attention`` (the mixer) and
``layer.ffn``, and ``model.head`` (the final norm and the logits).

DTensor programs: the bodies make some tensors themselves (rope angles,
masks, positions, ``torch.arange``, zeros); the caller runs a DTensor
program under ``torch.distributed.tensor.experimental.
implicit_replication()``, which takes each such plain tensor as replicated
on the mesh (``launch/dryrun.py`` does).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mb
from repro_torch.models import module as m
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.rope import text_positions
from repro_torch.sharding.apply import constrain, grad_like
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_map

DEFAULT_OPTS = {"impl": "xla", "wkv_impl": "xla",
                "moe_dispatch": "scatter", "remat": "none",
                "act_sharding": None, "unroll_layers": False}

REMATS = ("none", "full", "dots")


def _opts(opts: Optional[dict]) -> dict:
    unknown = (set(opts or {}) - set(DEFAULT_OPTS)
               - {"return_hidden", "fused_head"})
    if unknown:
        raise ValueError(f"unknown opts {sorted(unknown)}")
    opts = {**DEFAULT_OPTS, **(opts or {})}
    if opts["remat"] not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got "
                         f"{opts['remat']!r}")
    return opts


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """remat='dots': keep the weight products, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(remat: str):
    """The layer body under the remat policy."""
    if remat == "none":
        return _layer_full
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
    return functools.partial(checkpoint, _layer_full, use_reentrant=False,
                             **kw)


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
    if cfg.family == "hybrid":
        p["mamba"] = mb.init_mamba(gen, cfg, device)
        p["bnorm_attn"] = L.init_rmsnorm(cfg.d_model, device)
        p["bnorm_mamba"] = L.init_rmsnorm(cfg.d_model, device)
    if cfg.num_experts:
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def _has_embed(cfg: ModelConfig) -> bool:
    """Audio with a stub frontend reads frame embeddings: no table."""
    return not (cfg.family == "audio" and cfg.frontend_stub)


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> Dict[str, Any]:
    """Random params from ``gen`` (drawn on its device), on ``device``."""
    params: Dict[str, Any] = {}
    if _has_embed(cfg):
        params["embed"] = L.init_embedding(gen, cfg, device)
    params["layers"] = m.stack_layers(
        lambda g: _init_layer(g, cfg, device), gen, cfg.num_layers)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device)
    params["head"] = L.init_lm_head(gen, cfg, device)
    return params


def unstack(tree, n: int) -> list:
    """The n per-layer trees of a tree of stacked (L, ...) leaves, by one
    ``unbind`` a leaf (views).  Autograd then stacks the layers' gradients
    once; indexing a leaf per layer would build a full (L, ...) gradient
    for every layer and add them up (the same values, L times the
    traffic).  A DTensor layer's gradient is laid out as that layer's
    params (``sharding.apply.grad_like``)."""
    per = tree_map(lambda a: tuple(grad_like(t) for t in a.unbind(0)), tree)
    return [tree_map(lambda parts: parts[i], per) for i in range(n)]


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------

def _branch_mean(p, cfg: ModelConfig, a: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Hymba's mix of its attention and mamba branches."""
    return 0.5 * (L.rmsnorm(p["bnorm_attn"], a, cfg.norm_eps)
                  + L.rmsnorm(p["bnorm_mamba"], s, cfg.norm_eps))


def _mixer_full(p, cfg: ModelConfig, h: torch.Tensor, positions,
                opts) -> torch.Tensor:
    if cfg.family == "ssm":
        return rk.time_mix_full(p["time"], cfg, h, impl=opts["wkv_impl"])
    a = attn.attend_full(p["attn"], cfg, h, positions, impl=opts["impl"],
                         act=opts["act_sharding"])
    if cfg.family == "hybrid":
        # both branches' outputs (and their gradients) in the layer's
        # layout: DTensor would otherwise hand the gradient of each branch's
        # last product a layout that product's backward cannot take
        act = opts["act_sharding"]
        s = mb.mamba_full(p["mamba"], cfg, h)
        return _branch_mean(p, cfg, constrain(a, act, "B", None, None),
                            constrain(s, act, "B", None, None))
    return a


def _ffn_full(p, cfg: ModelConfig, h: torch.Tensor,
              opts) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.family == "ssm":
        return rk.channel_mix_full(p["channel"], cfg, h), _zero(h)
    if cfg.num_experts:
        return moe_mod.moe_ffn(p["moe"], cfg, h,
                               dispatch=opts["moe_dispatch"])
    return L.mlp(p["mlp"], h), _zero(h)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _layer_full(p, cfg: ModelConfig, x: torch.Tensor, positions, opts):
    act = opts["act_sharding"]
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    with trace.span("layer.attention", device=h):
        a = _mixer_full(p, cfg, h, positions, opts)
    # the residual after the mixer takes the layer's canonical layout too:
    # GSPMD carries it there from the constraints around it, DTensor needs
    # it stated (else its Partial sums reach the ffn in layouts its matmuls
    # cannot take)
    x = constrain(x + a, act, "B", None, None)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    with trace.span("layer.ffn", device=h):
        y, aux = _ffn_full(p, cfg, h, opts)
    return constrain(x + y, act, "B", None, None), aux


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                 dtype) -> torch.Tensor:
    """The input embedding of every modality (the stub frontends' carve-out):
    audio frames as given; vlm patch embeddings over the first P tokens."""
    if not _has_embed(cfg):
        return inputs["embeds"].to(dtype)                  # precomputed frames
    x = L.embed(params["embed"], inputs["tokens"], dtype)
    if cfg.family == "vlm" and "patch_embeds" in inputs:
        pe = inputs["patch_embeds"].to(dtype)              # (B, P, d)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def forward_full(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                 opts: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, vocab_padded), aux f32 scalar: the moe
    layers' load-balance terms summed, else 0), or the hidden states
    (B, S, d) in place of the logits with ``return_hidden``."""
    opts = _opts(opts)
    dtype = m.dtype_of(cfg.dtype)
    with trace.span("model.embed", device=inputs.get("tokens")):
        x = embed_inputs(params, cfg, inputs, dtype)
    x = constrain(x, opts["act_sharding"], "B", None, None)
    B, S = x.shape[:2]
    positions = inputs.get("positions")
    if positions is None:
        positions = text_positions(B, S, mrope=bool(cfg.mrope_sections),
                                   device=x.device)
    body = _remat(opts["remat"])
    auxs = []
    for p in unstack(params["layers"], cfg.num_layers):
        x, aux = body(p, cfg, x, positions, opts)
        auxs.append(aux)
    with trace.span("model.head", device=x):
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        aux = torch.sum(torch.stack(auxs))
        if opts.get("return_hidden"):
            return x, aux
        return L.lm_logits(params["head"], params.get("embed"), cfg, x), aux


# ---------------------------------------------------------------------------
# decode (single new token against carried per-layer state)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, context_len: int,
                      dtype, device=None) -> Dict[str, Any]:
    """Stacked (L, ...) per-layer state: the KV ring-buffer cache (and for
    hybrid the mamba conv window and ssm state), or the RWKV token shifts
    and WKV state (ssm)."""
    Lr = cfg.num_layers
    rep = lambda tree: tree_map(
        lambda a: a[None].expand((Lr,) + tuple(a.shape)).clone(), tree)
    if cfg.family == "ssm":
        return {"rwkv": rep(rk.init_rwkv_state(cfg, batch, dtype, device))}
    st = {"kv": rep(attn.init_cache(cfg, batch, context_len, dtype, device))}
    if cfg.family == "hybrid":
        st["mamba"] = rep(mb.init_mamba_state(cfg, batch, dtype, device))
    return st


def _layer_decode(p, cfg: ModelConfig, x, state, position, opts):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        y, rst = rk.time_mix_decode(p["time"], cfg, h, state["rwkv"])
        x = x + y
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, rst = rk.channel_mix_decode(p["channel"], cfg, h, rst)
        return x + y, {"rwkv": rst}
    y, kv = attn.attend_decode(p["attn"], cfg, h, state["kv"], position,
                               act=opts["act_sharding"])
    new_state = {"kv": kv}
    if cfg.family == "hybrid":
        s, new_state["mamba"] = mb.mamba_decode(p["mamba"], cfg, h,
                                                state["mamba"])
        y = _branch_mean(p, cfg, y, s)
    x = x + y
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if cfg.num_experts:
        y, _ = moe_mod.moe_ffn(p["moe"], cfg, h, dispatch=opts["moe_dispatch"])
    else:
        y = L.mlp(p["mlp"], h)
    return x + y, new_state


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                state: Dict[str, Any], position: torch.Tensor,
                opts: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B, 1) int; position: (B,) absolute index of the new token.
    Returns (logits (B, 1, vocab_padded), new_state)."""
    opts = _opts(opts)
    dtype = m.dtype_of(cfg.dtype)
    act = opts["act_sharding"]
    x = constrain(L.embed(params["embed"], token, dtype), act, "B", None,
                  None)
    new_states = []
    for p, st in zip(unstack(params["layers"], cfg.num_layers),
                     unstack(state, cfg.num_layers)):
        x, st = _layer_decode(p, cfg, x, st, position, opts)
        x = constrain(x, act, "B", None, None)
        new_states.append(st)
    new_state = tree_map(lambda *ls: torch.stack(ls), *new_states)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(params["head"], params.get("embed"), cfg, x), new_state
