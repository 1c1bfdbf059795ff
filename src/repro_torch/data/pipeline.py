"""Batching/iteration over host datasets, with epoch shuffling (numpy; a
copy of ``repro/data/pipeline.py``, the same batches for the same seed)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.data.synthetic import Dataset


def batches(ds: Dataset, batch_size: int, seed: int = 0,
            drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of shuffled minibatches."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    stop = (len(ds) // batch_size) * batch_size if drop_remainder else len(ds)
    if stop == 0 and len(ds) > 0:               # tiny client: one short batch
        yield ds.x[idx], ds.y[idx]
        return
    for s in range(0, stop, batch_size):
        take = idx[s:s + batch_size]
        yield ds.x[take], ds.y[take]


def epoch_count_steps(ds: Dataset, batch_size: int) -> int:
    return max(1, len(ds) // batch_size)
