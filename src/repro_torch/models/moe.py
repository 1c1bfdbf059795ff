"""Mixture-of-Experts FFN: top-k router and capacity-based scatter dispatch
(``repro/models/moe.py``).

Two dispatch strategies:

- ``scatter`` (default): tokens are written into a per-expert capacity
  buffer (E, C, d) at computed slot indices, the experts run as batched
  SwiGLU products over the expert axis (``torch.bmm``), and the outputs
  are gathered back.  A token routed past its expert's capacity C is
  dropped (its weight is zeroed), as in the reference.
- ``dense``: every expert processes every token and the router weights
  combine them in the down-projection's contraction.

The router's top-k puts the lower expert index first among equal
probabilities, as ``jax.lax.top_k`` does: ``torch.topk`` promises no order
for ties, so the port takes the first k of a stable sort.  The aux loss is
the Switch load-balance term ``E * sum_e f_e * P_e``.  The experts are
plain products outside any kernel, in the reference as here.

The scatter path's slots and (E, C, d) buffer have one plain
implementation, ``kernels/moe_dispatch/ref.py``.  On plain tensors outside
autograd (``module.einsum_path`` False: the inference paths) the slots,
the buffer and the combine run through ``kernels/moe_dispatch``'s
wrappers: hand-written CUDA kernels on the card, the plain code on the
CPU.  They give the plain slots and buffer bit for bit, and ``_combine``
up to the order of the f32 sum over a token's routes (each weighted row
rounded to the compute dtype, as here and in the reference).  Autograd
and DTensors keep the plain code.

Spans (``utils.trace``) of the scatter path: ``moe.dispatch`` (with
``moe.route``, the router and its top-k, inside it), ``moe.experts`` and
``moe.combine``, device spans on plain CUDA tensors and host spans on
DTensors; counters ``moe.routes`` (T·k routed tokens),
``moe.dropped_routes`` (those past their expert's capacity, summed on the
device while a recording is open) and ``moe.dispatch_kernel`` (one a
layer call that takes the kernels).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch import kernel as mdk, ref as mdr
from repro_torch.models import layers as L
from repro_torch.models import module as m
from repro_torch.sharding import apply as sh
from repro_torch.utils import trace

CAPACITY_FACTOR = 1.25


def init_moe(gen, cfg: ModelConfig, device=None):
    """Router (d, E) and the experts' SwiGLU weights stacked on (E, ...)."""
    pdt = m.dtype_of(cfg.param_dtype)
    E, d, ff = cfg.num_experts, cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)

    def one_expert(g):
        return {
            "w_gate": m.dense_init(g, d, ff, device, dtype=pdt),
            "w_up": m.dense_init(g, d, ff, device, dtype=pdt),
            "w_down": m.dense_init(g, ff, d, device, dtype=pdt),
        }

    return {
        "router": m.dense_init(gen, d, E, device, scale=0.02, dtype=pdt),
        "experts": m.stack_layers(one_expert, gen, E),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` routed tokens (Python floats, as
    the reference computes it)."""
    k, E = cfg.experts_per_token, cfg.num_experts
    return max(8, int(CAPACITY_FACTOR * tokens * k / E + 0.5))


def _expert_ffn(wp, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d) against the stacked (E, ...) expert weights."""
    dt = x.dtype
    gate = torch.bmm(x, wp["w_gate"].to(dt))
    up = torch.bmm(x, wp["w_up"].to(dt))
    return torch.bmm(L.silu(gate) * up, wp["w_down"].to(dt))


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, the lower index first
    among equals (``jax.lax.top_k``'s order)."""
    idx = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return torch.gather(probs, -1, idx), idx


def _route(params, cfg: ModelConfig, x2d: torch.Tensor):
    """Router top-k.  x2d: (T, d) -> (weights (T, k) in x's dtype,
    experts (T, k) int64, aux f32 scalar)."""
    logits = (x2d @ params["router"].to(x2d.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    top_w, top_e = top_k(probs, cfg.experts_per_token)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # Switch load-balance aux: fraction routed vs mean prob, per expert
    onehot = torch.nn.functional.one_hot(top_e[:, 0], cfg.num_experts)
    f = torch.mean(onehot.to(torch.float32), dim=0)
    P = torch.mean(probs, dim=0)
    aux = cfg.num_experts * torch.sum(f * P)
    return top_w.to(x2d.dtype), top_e, aux


def moe_dense(params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-experts path.  x: (B, S, d) -> (y, aux).  The router combine is
    folded into the down-projection's contraction over (e, f)."""
    B, S, d = x.shape
    x2d = sh.reshape(x, B * S, d)
    top_w, top_e, aux = _route(params, cfg, x2d)
    dt = x.dtype
    ex = params["experts"]
    gate = torch.einsum("td,edf->tef", x2d, ex["w_gate"].to(dt))
    up = torch.einsum("td,edf->tef", x2d, ex["w_up"].to(dt))
    combine = torch.zeros((B * S, cfg.num_experts), dtype=dt,
                          device=x.device).scatter_add_(1, top_e, top_w)
    hidden = (L.silu(gate) * up) * combine[..., None]         # (T, E, F)
    y = torch.einsum("tef,efd->td", hidden, ex["w_down"].to(dt))
    return sh.reshape(y, B, S, d), aux


def _dispatch(params, cfg: ModelConfig, x: torch.Tensor, device=False,
              kernels: bool = False):
    """Router, top-k, capacity slots and the (E, C, d) expert buffer.
    x: (B, S, d) -> (expert_in (E, C, d), slot (T·k,), keep (T·k,),
    flat_w (T·k,), aux).  The slots and the buffer come from
    ``kernels/moe_dispatch``'s plain code (``ref.slots_ref``,
    ``ref.scatter_ref``), or with ``kernels`` from its wrappers, which
    give the same bits.  ``device`` is the ``moe.route`` span's
    (``utils.trace.span``): False on gathered replicas, a host span."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(T, cfg)
    x2d = x.reshape(T, d)
    with trace.span("moe.route", device=device):
        top_w, top_e, aux = _route(params, cfg, x2d)
    flat_e = top_e.reshape(T * k)
    if kernels:
        slot, keep, counts = mdk.moe_slots(flat_e, E, C)
        buf = mdk.moe_scatter(x2d.contiguous(), slot, counts, E, C, k)
    else:
        slot, keep, counts = mdr.slots_ref(flat_e, E, C)
        buf = mdr.scatter_ref(x2d, slot, E, C, k)
    trace.count("moe.routes", T * k)
    if trace.active():
        trace.count("moe.dropped_routes",
                    torch.clamp(counts - C, min=0).sum())
    return buf, slot, keep, top_w.reshape(T * k), aux


def _combine(expert_out: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor, flat_w: torch.Tensor, B: int, S: int,
             k: int) -> torch.Tensor:
    """Expert outputs (E, C, d) back into token order, weighted: (B, S, d)."""
    E, C, d = expert_out.shape
    flat_out = torch.cat([expert_out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=expert_out.dtype,
                                      device=expert_out.device)], dim=0)
    y_tok = flat_out[slot] * (flat_w * keep.to(flat_w.dtype))[:, None]
    y = y_tok.reshape(B * S, k, d).sum(dim=1) if k > 1 else y_tok
    return y.reshape(B, S, d)


def moe_scatter(params, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity scatter/gather path.  x: (B, S, d) -> (y, aux).

    On plain tensors outside autograd the slots, the buffer and the
    combine run through ``kernels/moe_dispatch`` (counted by
    ``moe.dispatch_kernel``); where autograd records, through the plain
    code.

    On DTensors the dispatch (router, stable top-k, slot scan, the scatter
    into the (E, C, d) buffer) and the combine run on gathered replicas
    (``sharding.apply.on_replicas``): the capacity is shared by every
    token of the batch, so no split of the batch keeps them exact.  The
    experts run on the weights' own shards
    (``sharding.apply.experts_on_shards``): E over the model axis where
    the expert count divides it (llama4), else each expert's hidden dim
    (granite), so each rank does 1/model of the experts' work, as the
    reference's GSPMD partition does."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    if not sh.is_dtensor(x):
        kernels = not m.einsum_path(x, params["router"],
                                    *params["experts"].values())
        if kernels:
            trace.count("moe.dispatch_kernel", 1)
        with trace.span("moe.dispatch", device=x):
            expert_in, slot, keep, flat_w, aux = _dispatch(
                params, cfg, x, device=x, kernels=kernels)
        with trace.span("moe.experts", device=x):
            expert_out = _expert_ffn(params["experts"], expert_in)
        with trace.span("moe.combine", device=x):
            if kernels:
                y = mdk.moe_combine(expert_out, slot, flat_w, k)
                return y.reshape(B, S, d), aux
            return _combine(expert_out, slot, keep, flat_w, B, S, k), aux
    with trace.span("moe.dispatch"):
        expert_in, slot, keep, flat_w, aux = sh.on_replicas(
            lambda r, h: _dispatch({"router": r}, cfg, h), params["router"],
            x)
    with trace.span("moe.experts"):
        expert_out = sh.experts_on_shards(_expert_ffn, params["experts"],
                                          expert_in)
    with trace.span("moe.combine"):
        y = sh.on_replicas(lambda *a: _combine(*a, B, S, k), expert_out,
                           slot, keep, flat_w)
    return y, aux


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor,
            dispatch: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """``"dense"`` selects ``moe_dense``; anything else the scatter path,
    as in the reference.  On DTensors the scatter path runs its dispatch
    and combine on gathered replicas and its experts on the weights'
    shards (``moe_scatter``); the dense path, every expert on every
    token, runs whole on replicas (``sharding.apply.on_replicas``: every
    rank does all of its work).  The moe blocks take their layout from
    the weights, not from the activation map."""
    if dispatch == "dense":
        return sh.on_replicas(lambda p, h: moe_dense(p, cfg, h), params, x)
    return moe_scatter(params, cfg, x)
