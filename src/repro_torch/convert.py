"""Param trees across the two packages, as numpy.

Both packages keep the same layout (NHWC images, HWIO conv weights,
(in, out) dense weights) and the same nested-dict keys, so a tree moves
across with no transposes::

    tree = jax.tree_util.tree_map(np.asarray, sim_jax.params)
    sim_torch.params = params_from_numpy(tree, sim_torch.device)
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
