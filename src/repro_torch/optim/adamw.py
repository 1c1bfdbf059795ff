"""AdamW with fp32 master moments; params may live in bf16
(``repro/optim/adamw.py``).

The reference's arithmetic order, op for op: the bias corrections from the
incremented step, ``u = -lr * (mhat / (sqrt(vhat) + eps))``, then decoupled
weight decay on the leaves of two or more dims.  ``torch.optim.AdamW``
is not used: its decay and bias correction round otherwise.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.sgd import Optimizer, step_counter
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def adamw(learning_rate: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype=torch.float32) -> Optimizer:
    """moment_dtype=torch.bfloat16 halves the m/v optimizer-state
    footprint."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return {
            "step": step_counter(params),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
        }

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr = lr_fn(step)
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m2 = b1 * m.to(torch.float32) + (1 - b1) * gf
            v2 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(gf)
            mhat = m2 / bc1
            vhat = v2 / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps))
            if weight_decay and p is not None and p.dim() >= 2:
                u = u - lr * weight_decay * p.to(torch.float32)
            return u, m2.to(moment_dtype), v2.to(moment_dtype)

        flat_g = tree_leaves(grads)
        flat_p = (tree_leaves(params) if params is not None
                  else [None] * len(flat_g))
        out = [upd(g, m, v, p) for g, m, v, p in zip(
            flat_g, tree_leaves(state["m"]), tree_leaves(state["v"]), flat_p)]
        unflat = lambda j: tree_unflatten(grads, iter(o[j] for o in out))
        return unflat(0), {"step": step, "m": unflat(1), "v": unflat(2)}

    return Optimizer(init, update)
