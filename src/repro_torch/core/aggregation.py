"""Global aggregation on lists of param trees (``repro/core/aggregation.py``).

- ``fedavg``: Alg. 1 line 15 / Alg. 2 line 15 (uniform over received).
- ``fedasync_weight``: the polynomial staleness weight α(t−τ+1)^(−a).
- ``fedasync_merge``: the server-side async merge.

The schemes' ``aggregate_host`` uses these where a round selected nobody.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.utils.tree import tree_leaves, tree_lerp, tree_map


def fedavg(updates: Sequence[Any], weights: Sequence[float] | None = None) -> Any:
    """Weighted average of param trees (uniform when weights is None)."""
    if not updates:
        raise ValueError("fedavg needs at least one update")
    dev = tree_leaves(updates[0])[0].device
    if weights is None:
        ws = torch.full((len(updates),), 1.0 / len(updates),
                        dtype=torch.float32, device=dev)
    else:
        ws = torch.tensor(list(weights), dtype=torch.float32, device=dev)
        ws = ws / torch.sum(ws)

    def avg(*leaves):
        stacked = torch.stack(leaves)
        return torch.tensordot(ws, stacked.float(), dims=1).to(stacked.dtype)

    return tree_map(avg, *updates)


def fedasync_weight(staleness: int, alpha: float = 0.4, a: float = 0.5) -> float:
    """α(t−τ+1)^(−a): weight for a model update delayed by ``staleness``."""
    return alpha * float(staleness + 1) ** (-a)


def fedasync_merge(global_params: Any, delayed_update: Any, staleness: int,
                   alpha: float = 0.4, a: float = 0.5) -> Any:
    """Server-side async merge: ω ← (1−α_t)·ω + α_t·ω_delayed."""
    w = fedasync_weight(staleness, alpha, a)
    return tree_lerp(global_params, delayed_update, w)
