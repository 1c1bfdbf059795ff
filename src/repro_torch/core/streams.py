"""The device engine's one source of randomness: a stream per simulation.

The on-device round (``core/fused_round.build_device_round``) and the sweep
(``core/sweep``) take every random draw from a ``SimStream``:

- the initial params (``init_params``);
- the fleet's draws, in the order the reference's fleet consumes its key:
  ``fleet_init_draws`` (the five draws of ``fleet_init``), then one
  ``fleet_uniform`` per fading resample and per outage step and one
  ``fleet_normal`` per move;
- the batch indices of every local epoch (``batch_indices``), drawn for
  each config of the simulation from the same random numbers (the
  reference vmaps one key over its configs), each row below its user's
  dataset length.

A row of a sweep depends only on its own simulation's stream, never on
which other simulations or configs share its group.

``TorchStream`` is the default: a ``torch.Generator`` on the run's device
per simulation, seeded from the simulation's seed, and the port's
``models/cnn.init_cnn(seed)`` for the params, so the device engine starts
where ``HSFLSimulation`` does.  Its batch indices are ``floor(u·clen)``
of uniform u, clamped to ``clen - 1`` (in f32, ``u·clen`` rounds up to
``clen`` for u near 1).  A test may pass any other ``SimStream`` (the
parity tests replay the reference's ``jax.random`` draws through one):
torch cannot reproduce ``jax.random`` on its own, so seeded runs of the two
packages agree in distribution, not draw for draw.

``GroupStream`` stacks the streams of a sweep group's simulations on a
leading axis.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.channel_lib import ChannelParams
from repro_torch.models import cnn as cnn_mod

__all__ = ["SimStream", "TorchStream", "GroupStream", "torch_stream"]


class SimStream:
    """One simulation's draws (the interface ``build_device_round`` reads).
    Every tensor is f32 on ``device`` except where stated."""

    device: torch.device

    def init_params(self):
        """The initial global params."""
        raise NotImplementedError

    def fleet_init_draws(self, n: int, p: ChannelParams):
        """(u_r, u_ang, z, k_db, u_bad), each (n,): u_* uniform in [0, 1),
        z uniform in ``p.uav_z_range``, k_db in ``p.k_db_range``."""
        raise NotImplementedError

    def fleet_uniform(self, n: int, lo: float = 0.0, hi: float = 1.0):
        """(n,) uniform in [lo, hi): one fleet transition."""
        raise NotImplementedError

    def fleet_normal(self, shape: Sequence[int]):
        """Standard normal draws of ``shape``: one fleet transition."""
        raise NotImplementedError

    def batch_indices(self, round_t: int, e_t: int, clen: torch.Tensor,
                      n: int) -> torch.Tensor:
        """Sample indices (C, K, n) int64 for local epoch ``e_t`` of round
        ``round_t`` (both from 1): row (c, k) uniform in [0, clen[c, k]),
        for clen (C, K) int64 >= 1."""
        raise NotImplementedError


class TorchStream(SimStream):
    """Seeded ``torch.Generator`` draws on ``device`` (the default).
    ``draw_on="cpu"`` draws on the CPU and copies each draw to ``device``:
    the same numbers on the card and on the CPU (the card-vs-CPU checks
    use it; the copies make the round wait for the host)."""

    def __init__(self, seed: int, device, draw_on=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.draw_on = torch.device(draw_on or self.device)
        self.gen = torch.Generator(self.draw_on).manual_seed(self.seed + 1)

    def init_params(self):
        return cnn_mod.init_cnn(self.seed, self.device)

    def _rand(self, shape):
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.draw_on).to(self.device)

    def fleet_init_draws(self, n: int, p: ChannelParams):
        u_r, u_ang = self._rand((n,)), self._rand((n,))
        z = self.fleet_uniform(n, *p.uav_z_range)
        k_db = self.fleet_uniform(n, *p.k_db_range)
        return u_r, u_ang, z, k_db, self._rand((n,))

    def fleet_uniform(self, n: int, lo: float = 0.0, hi: float = 1.0):
        return self._rand((n,)) * (hi - lo) + lo

    def fleet_normal(self, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.draw_on).to(self.device)

    def batch_indices(self, round_t, e_t, clen, n):
        u = self._rand((clen.shape[-1], n))             # one draw per (k, j)
        cl = clen[..., None]
        return torch.minimum((u * cl).long(), cl - 1)


def torch_stream(cfg, device) -> TorchStream:
    """The default stream factory of the sweep: ``cfg.seed`` seeds it."""
    return TorchStream(cfg.seed, device)


class GroupStream:
    """The streams of a group's S simulations, stacked on a leading axis:
    fleet draws (S, ...), batch indices (S·C, K, n) in (sim, config)
    order."""

    def __init__(self, streams: List[SimStream]):
        self.streams = list(streams)

    def init_params(self) -> list:
        return [s.init_params() for s in self.streams]

    def fleet_init_draws(self, n: int, p: ChannelParams):
        per = [s.fleet_init_draws(n, p) for s in self.streams]
        return tuple(torch.stack(d) for d in zip(*per))

    def fleet_uniform(self, n: int, lo: float = 0.0, hi: float = 1.0):
        return torch.stack([s.fleet_uniform(n, lo, hi)
                            for s in self.streams])

    def fleet_normal(self, shape):
        return torch.stack([s.fleet_normal(shape) for s in self.streams])

    def batch_indices(self, round_t: int, e_t: int, clen: torch.Tensor,
                      n: int) -> torch.Tensor:
        """clen (S·C, K) -> indices (S·C, K, n)."""
        s = len(self.streams)
        per = clen.reshape(s, -1, clen.shape[-1])
        return torch.cat([st.batch_indices(round_t, e_t, per[i], n)
                          for i, st in enumerate(self.streams)])
