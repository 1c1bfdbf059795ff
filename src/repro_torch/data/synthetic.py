"""Synthetic datasets (numpy; array-equal to ``repro/data/synthetic.py``).

``make_digits`` builds a 10-class image problem whose classes are
deterministic smoothed prototype blobs + per-sample jitter/noise.
``make_token_stream`` builds LM token data with Zipfian unigrams + Markov
bigram structure for the zoo's training.  Both must stay array-equal to
the reference for the same seed (``tests/test_torch_control.py``,
``tests/test_torch_optim.py``).

``make_digits`` draws what the reference draws, in its order, but as
whole arrays: its n images' noise is one ``standard_normal((n, side,
side))`` (a ``Generator`` keeps no state between draws, so that is the
n per-image draws' numbers), each image's ``np.roll`` is a gather, and
the sums run in f32 over the same contiguous (n, side, side, 1) array.
It holds the GIL only between those array operations, so simulations
can build their data on threads (``core/sweep._stack_sims``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


@dataclass
class Dataset:
    x: np.ndarray     # images (N, 28, 28, 1) float32 or tokens (N, S) int32
    y: np.ndarray     # labels (N,) or next-token targets (N, S)

    def __len__(self) -> int:
        return len(self.x)


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    for _ in range(iters):
        img = (img
               + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


@lru_cache(maxsize=None)
def _prototypes(side: int, num_classes: int) -> np.ndarray:
    """The class shapes (C, side, side), fixed across sims; read-only."""
    protos = []
    proto_rng = np.random.default_rng(1234)
    for _ in range(num_classes):
        base = (proto_rng.random((side, side)) < 0.18).astype(np.float32)
        protos.append(_smooth(base, 4) * 3.0)
    protos = np.stack(protos)
    protos.setflags(write=False)
    return protos


def make_digits(n: int, seed: int = 0, side: int = 28,
                num_classes: int = 10, noise: float = 0.8) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = _prototypes(side, num_classes)
    y = rng.integers(0, num_classes, n)
    shifts = rng.integers(-3, 4, (n, 2))
    z = rng.standard_normal((n, side, side)).astype(np.float32)
    z *= noise
    # np.roll(p, (a, b), (0, 1)) is the window of p tiled 2x2 that starts
    # at (-a mod side, -b mod side)
    windows = sliding_window_view(np.tile(protos, (1, 2, 2)), (side, side),
                                  axis=(1, 2))
    xs = windows[y, -shifts[:, 0] % side, -shifts[:, 1] % side]
    xs += z
    xs = xs.reshape(n, side, side, 1)
    mean, std = xs.mean(), xs.std() + 1e-6
    return Dataset(((xs - mean) / std).astype(np.float32, copy=False),
                   y.astype(np.int32))


def make_token_stream(n_seqs: int, seq_len: int, vocab: int,
                      seed: int = 0) -> Dataset:
    """Zipf unigram + noisy-successor bigram LM data."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    succ = rng.permutation(vocab)                # deterministic bigram skeleton
    toks = np.empty((n_seqs, seq_len + 1), np.int64)
    toks[:, 0] = rng.choice(vocab, n_seqs, p=probs)
    for t in range(seq_len):
        follow = rng.random(n_seqs) < 0.7
        toks[:, t + 1] = np.where(follow, succ[toks[:, t]],
                                  rng.choice(vocab, n_seqs, p=probs))
    return Dataset(toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))
