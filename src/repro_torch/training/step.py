"""The loss, the train step and the serving steps
(``repro/training/step.py``).

``make_train_step`` differentiates ``loss_fn`` with ``torch.autograd``:
the params are detached and marked as requiring a gradient, so the
full-sequence forward takes the reference's differentiable einsum paths
(``models.attention._sdpa``/``_sdpa_chunked``, ``models.rwkv6.wkv_scan``)
and never the forward-only kernels.  ``make_prefill_step`` and
``make_decode_step`` run under ``torch.no_grad()``, so they go through the
kernels.  Every step runs on the model's device (``build_model``'s
``device``; the card by default).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.sgd import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.sharding.apply import is_dtensor, like
from repro_torch.training.loss import cross_entropy, fused_head_cross_entropy
from repro_torch.training.train_state import TrainState
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def loss_fn(model: Model, params, batch: Dict[str, Any],
            opts: Optional[dict] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"ce", "aux"}): the mean CE over ``batch["labels"]`` (masked
    by ``batch["mask"]`` if given), plus ``router_aux_coef`` x the moe
    load-balance term for moe configs.  ``opts["fused_head"]`` computes the
    CE from the hidden states chunk by chunk."""
    mask = batch.get("mask")
    if opts and opts.get("fused_head"):
        hidden, aux = model.forward(params, batch,
                                    {**opts, "return_hidden": True})
        ce = fused_head_cross_entropy(params.get("head"), params.get("embed"),
                                      model.cfg, hidden, batch["labels"], mask)
    else:
        logits, aux = model.forward(params, batch, opts)
        ce = cross_entropy(logits, batch["labels"], mask)
    total = ce + model.cfg.router_aux_coef * aux if model.cfg.num_experts else ce
    return total, {"ce": ce, "aux": aux}


def value_and_grad(model: Model, params, batch: Dict[str, Any],
                   opts: Optional[dict] = None):
    """((loss, parts), grads) of ``loss_fn`` at ``params``, grads in the
    params' structure; a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it.  A DTensor param's gradient is laid out as the
    param."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(model, tree_unflatten(params, iter(leaves)),
                              batch, opts)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None
             else like(g, p.placements) if is_dtensor(p) else g
             for p, g in zip(leaves, grads)]
    parts = {k: v.detach() if isinstance(v, torch.Tensor) else v
             for k, v in parts.items()}
    return (loss.detach(), parts), tree_unflatten(params, iter(grads))


def make_train_step(model: Model, optimizer: Optimizer,
                    opts: Optional[dict] = None,
                    grad_clip: float = 0.0) -> Callable:
    """Returns step(state, batch) -> (state, metrics): the metrics
    ``loss``, ``ce`` and ``aux`` as tensors on the device (no host read
    inside the step)."""

    def step(state: TrainState, batch: Dict[str, Any]):
        (loss, parts), grads = value_and_grad(model, state.params, batch,
                                              opts)
        with torch.no_grad():
            if grad_clip:
                grads = clip_by_global_norm(grads, grad_clip)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
        new_state = state._replace(params=params, opt_state=opt_state,
                                   step=state.step + 1)
        return new_state, {"loss": loss, **parts}

    return step


def make_prefill_step(model: Model, opts: Optional[dict] = None) -> Callable:
    """Forward-only step (inference prefill / encoder encode).  ``batch``
    is ``models.inputs``' prefill structure: ``tokens``; ``embeds`` for
    audio; ``patch_embeds`` and ``positions`` for vlm.  Each call is one
    ``prefill.step`` span (``utils.trace``), on the card a device span."""

    @torch.no_grad()
    def step(params, batch: Dict[str, Any]):
        with trace.span("prefill.step", device=batch.get("tokens")):
            logits, _ = model.forward(params, batch, opts)
        return logits

    return step


def make_decode_step(model: Model, opts: Optional[dict] = None) -> Callable:
    """One-token serve step: (params, token, state, position) -> (logits, state)."""
    if model.decode is None:
        raise ValueError(f"{model.cfg.name} has no decode step")

    @torch.no_grad()
    def step(params, token, state, position):
        return model.decode(params, token, state, position, opts)

    return step
