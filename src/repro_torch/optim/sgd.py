"""SGD (+ optional momentum), mini-optax style: ``init``/``update`` pairs
over param trees (``repro/optim/sgd.py``).

Functions on tensor trees in the reference's arithmetic order, leaf by
leaf, in ``utils.tree.tree_leaves`` order (sorted keys, as
``jax.tree_util``), so that a sum over the leaves (the global norm) adds
them in the reference's order.  The step counter is a 0-dim int32 tensor
on the params' device; nothing reads it back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]   # (grads, state, params)


def apply_updates(params: Any, updates: Any) -> Any:
    """p + u, in each param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def step_counter(params: Any) -> torch.Tensor:
    """A zero int32 step on the params' device."""
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(learning_rate: float | Callable[[torch.Tensor], torch.Tensor],
        momentum: float = 0.0) -> Optimizer:
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        state = {"step": step_counter(params)}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(grads, state, params=None):
        del params
        lr = lr_fn(state["step"])
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            updates = tree_map(lambda m: -lr * m, mu)
            return updates, {"step": state["step"] + 1, "mu": mu}
        updates = tree_map(lambda g: -lr * g, grads)
        return updates, {"step": state["step"] + 1}

    return Optimizer(init, update)


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    """Scale the grads so that their global L2 norm is at most
    ``max_norm``; the squares are summed in f32, leaf by leaf."""
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(grads)]
    norm = torch.sqrt(sum(leaves))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)
