"""Inputs the benchmark makes from ``--seed`` and hands to both the program
and the plain references: derived seeds, the FL simulations' random draws,
the zoo's weights and token batches.

Nothing here imports the program: the references take their inputs from
this module as the program does.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import torch


def derive_seed(seed: int, *path) -> int:
    """A 31-bit seed for the part of a run named by ``path``, from the run's
    ``--seed`` (any whole number): the same seed and path give the same
    number."""
    text = "/".join(str(p) for p in (int(seed),) + tuple(path))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:4],
                          "little") & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# FL simulations
# ---------------------------------------------------------------------------

def cnn_init(gen: torch.Generator, layout: Dict, device) -> Dict:
    """The CNN's initial params in the layout of the configuration's
    ``param_shapes`` (a weight ``w`` drawn normal with standard deviation
    fan_in^-1/2, its fan-in the product of all but its last dimension; a
    bias ``b`` zero), drawn from ``gen`` in the layout's sorted order."""
    out = {}
    for layer in sorted(layout):
        out[layer] = {}
        for name in sorted(layout[layer]):
            shape = tuple(layout[layer][name])
            if name == "b":
                out[layer][name] = torch.zeros(shape, device=device)
            else:
                fan_in = math.prod(shape[:-1])
                w = torch.randn(shape, generator=gen, device=gen.device)
                out[layer][name] = (w * fan_in ** -0.5).to(device)
    return out


class PanelStream:
    """One FL simulation's random draws, in the interface of the port's
    ``core.streams.SimStream``, from a ``torch.Generator`` on ``device``
    seeded with the simulation's seed.  The reference makes the same calls
    in the same order and gets the same numbers."""

    def __init__(self, seed: int, device, layout: Dict):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.layout = layout
        self.gen = torch.Generator(self.device).manual_seed(self.seed)

    def _rand(self, shape):
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device)

    def init_params(self):
        return cnn_init(self.gen, self.layout, self.device)

    def fleet_init_draws(self, n: int, p):
        u_r, u_ang = self._rand((n,)), self._rand((n,))
        z = self.fleet_uniform(n, *p.uav_z_range)
        k_db = self.fleet_uniform(n, *p.k_db_range)
        return u_r, u_ang, z, k_db, self._rand((n,))

    def fleet_uniform(self, n: int, lo: float = 0.0, hi: float = 1.0):
        return self._rand((n,)) * (hi - lo) + lo

    def fleet_normal(self, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def batch_indices(self, round_t: int, e_t: int, clen: torch.Tensor,
                      n: int) -> torch.Tensor:
        """(C, K, n) indices, row (c, k) uniform below clen[c, k]: one
        draw of (K, n) shared by the configs."""
        u = self._rand((clen.shape[-1], n))
        cl = clen[..., None]
        return torch.minimum((u * cl).long(), cl - 1)


def panel_seeds(seed: int, panel: int, n: int) -> List[int]:
    """The simulation seeds of panel ``panel`` of a run."""
    return [derive_seed(seed, "panel", panel, j) for j in range(n)]


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

def zoo_weights(seed: int, leaves: Sequence, device) -> Dict:
    """Random weights for a params tree, made on ``device`` from ``seed``
    in one draw: ``leaves`` lists (path, shape, init) with ``init`` one of
    ``("ones",)``, ``("normal", std)``.  Every leaf is a float32 view of
    one buffer; returns the nested dict of ``path`` ("a.b.c")."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device).manual_seed(derive_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict = {}
    off = 0
    for path, shape, init in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(tuple(shape))
        off += n
        if init[0] == "ones":
            leaf.fill_(1.0)
        else:
            leaf.mul_(float(init[1]))
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def token_batch(seed: int, index: int, batch: int, seq: int, vocab: int,
                device) -> torch.Tensor:
    """(batch, seq) int64 token ids uniform below ``vocab``, batch
    ``index`` of a run."""
    gen = torch.Generator(device).manual_seed(derive_seed(seed, "tokens",
                                                          index))
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)
