"""Param trees across the two packages, as numpy.

Both packages keep the same layout (NHWC images, HWIO conv weights,
(in, out) dense weights) and the same nested-dict keys, so a tree moves
across with no transposes::

    tree = jax.tree_util.tree_map(np.asarray, sim_jax.params)
    sim_torch.params = params_from_numpy(tree, sim_torch.device)

A ``TrainState`` crosses the same way, field by field (params, the
optimizer state's ``step``/``m``/``v``/``mu``, the step and the snapshot
slots; None fields stay None)::

    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, j_state),
                             "cpu")
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.training.train_state import TrainState
from repro_torch.utils.tree import tree_map


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def state_from_numpy(state: Any, device) -> TrainState:
    """A train state of numpy leaves (the reference's ``TrainState``, or
    any tuple of its six fields in order) -> the port's, on ``device``."""
    return TrainState(*(None if f is None else params_from_numpy(f, device)
                        for f in state))


def state_to_numpy(state: TrainState) -> TrainState:
    """The port's train state with numpy leaves; ``TrainState(*fields)`` of
    the reference takes its fields in this order."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
