"""Synthetic datasets (numpy; a copy of ``repro/data/synthetic.py``).

``make_digits`` builds a 10-class image problem whose classes are
deterministic smoothed prototype blobs + per-sample jitter/noise.
``make_token_stream`` builds LM token data with Zipfian unigrams + Markov
bigram structure for the zoo's training.  The copy must stay array-equal
to the reference for the same seed (``tests/test_torch_control.py``,
``tests/test_torch_optim.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def make_digits(n: int, seed: int = 0, side: int = 28,
                num_classes: int = 10, noise: float = 0.8) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = []
    proto_rng = np.random.default_rng(1234)      # class shapes fixed across sims
    for _ in range(num_classes):
        base = (proto_rng.random((side, side)) < 0.18).astype(np.float32)
        protos.append(_smooth(base, 4) * 3.0)
    protos = np.stack(protos)                    # (C, side, side)

    y = rng.integers(0, num_classes, n)
    shifts = rng.integers(-3, 4, (n, 2))
    xs = np.empty((n, side, side, 1), np.float32)
    for i in range(n):
        img = np.roll(protos[y[i]], tuple(shifts[i]), (0, 1))
        img = img + rng.standard_normal((side, side)).astype(np.float32) * noise
        xs[i, :, :, 0] = img
    mean, std = xs.mean(), xs.std() + 1e-6
    return Dataset(((xs - mean) / std).astype(np.float32), y.astype(np.int32))


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
