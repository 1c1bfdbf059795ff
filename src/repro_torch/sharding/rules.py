"""The sweep's split of its stacked-simulation axis over ranks
(``shard_sweep_tree``/``sweep_leading_spec`` of
``repro/sharding/rules.py``).  The parameter specs of the same file are
not ported.
"""
from __future__ import annotations

from typing import Tuple


def sweep_rows(n_sims: int, world: int, rank: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` block of a group's ``n_sims`` simulation rows that
    ``rank`` of ``world`` runs: contiguous blocks of ``n_sims / world``
    when ``world`` divides ``n_sims``, else every row on every rank (the
    reference replicates)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if n_sims % world:
        return 0, n_sims
    per = n_sims // world
    return rank * per, (rank + 1) * per
