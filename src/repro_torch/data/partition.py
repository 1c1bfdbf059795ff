"""Federated data partitioning (numpy; a copy of ``repro/data/partition.py``).

- iid: uniform random split.
- non-iid: label-sorted shards, 2 classes per client.
- imbalanced: Dirichlet class skew + power-law size imbalance
  (α_d = 0.01, α_imd = 2).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import Dataset


def _subset(ds: Dataset, idx: np.ndarray) -> Dataset:
    return Dataset(ds.x[idx], ds.y[idx])


def partition_iid(ds: Dataset, n_clients: int, seed: int = 0) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return [_subset(ds, part) for part in np.array_split(idx, n_clients)]


def partition_noniid(ds: Dataset, n_clients: int, classes_per_client: int = 2,
                     seed: int = 0) -> List[Dataset]:
    """Each client sees exactly ``classes_per_client`` classes; class pools
    are sliced round-robin so shards never straddle a class boundary."""
    rng = np.random.default_rng(seed)
    classes = np.unique(ds.y)
    pools = {c: rng.permutation(np.where(ds.y == c)[0]) for c in classes}
    picks = []
    for i in range(n_clients):
        start = (i * classes_per_client) % len(classes)
        picks.append([classes[(start + j) % len(classes)]
                      for j in range(classes_per_client)])
    rng.shuffle(picks)
    uses = {c: sum(c in row for row in picks) for c in classes}
    cursor = {c: 0 for c in classes}
    out = []
    for row in picks:
        idx = []
        for c in row:
            share = len(pools[c]) // max(uses[c], 1)
            s = cursor[c]
            idx.append(pools[c][s:s + share])
            cursor[c] += share
        out.append(_subset(ds, np.concatenate(idx)))
    return out


def partition_imbalanced(ds: Dataset, n_clients: int, alpha_d: float = 0.01,
                         alpha_imd: float = 2.0, seed: int = 0) -> List[Dataset]:
    """Dirichlet class skew + power-law size imbalance."""
    rng = np.random.default_rng(seed)
    classes = np.unique(ds.y)
    by_class = {c: rng.permutation(np.where(ds.y == c)[0]) for c in classes}
    used = {c: 0 for c in classes}
    raw = rng.pareto(alpha_imd, n_clients) + 1.0
    sizes = np.maximum((raw / raw.sum() * len(ds)).astype(int), 8)
    out = []
    for i in range(n_clients):
        pvec = rng.dirichlet(np.full(len(classes), alpha_d))
        counts = rng.multinomial(sizes[i], pvec)
        take = []
        for c, k in zip(classes, counts):
            pool = by_class[c]
            start = used[c]
            grab = pool[start:start + k]
            used[c] = min(start + k, len(pool))
            take.append(grab)
        idx = np.concatenate(take) if take else np.empty(0, int)
        if len(idx) == 0:                    # guarantee non-empty clients
            idx = rng.integers(0, len(ds), 8)
        out.append(_subset(ds, idx))
    return out


def partition(ds: Dataset, n_clients: int, dist: str, seed: int = 0) -> List[Dataset]:
    if dist == "iid":
        return partition_iid(ds, n_clients, seed)
    if dist == "noniid":
        return partition_noniid(ds, n_clients, seed=seed)
    if dist == "imbalanced":
        return partition_imbalanced(ds, n_clients, seed=seed)
    raise ValueError(f"unknown distribution {dist!r}")
