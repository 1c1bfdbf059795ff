"""Wireless channel model, host side (numpy; a copy of ``repro/core/channel.py``).

``UAVFleet`` owns the ``np.random.Generator`` whose draw order the fused
round replays: the port consumes it in exactly the reference's order, so
both packages see the same channel for the same seed.  The unit
interpretations of eqs. (1)–(7) are documented in the reference module.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.channel_lib import ChannelParams, outage_transitions
from repro_torch.core import channel_lib as _lib

__all__ = ["ChannelParams", "UAVFleet", "rate_bps"]


def rate_bps(pos: np.ndarray, k_db: np.ndarray, p: ChannelParams,
             bandwidth_ratio: float = 1.0) -> np.ndarray:
    """eq. (7): Shannon rate in bits/s for allocated bandwidth n_i·B_uav."""
    return _lib.rate_bps(pos, k_db, p, bandwidth_ratio, xp=np)


@dataclass
class UAVFleet:
    """Random-flight UAVs inside the cell; channel resampled per local epoch."""
    n: int
    params: ChannelParams = field(default_factory=ChannelParams)
    seed: int = 0
    speed_mps: float = 15.0
    epoch_seconds: float = 1.0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        r = self.params.cell_radius_m * np.sqrt(self.rng.random(self.n))
        ang = self.rng.random(self.n) * 2 * np.pi
        z = self.rng.uniform(*self.params.uav_z_range, self.n)
        self.pos = np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=-1)
        self.k_db = self.rng.uniform(*self.params.k_db_range, self.n)
        # Gilbert-Elliott interruption chain (stationary prob = outage_prob)
        self._bad = self.rng.random(self.n) < self.params.outage_prob

    def resample_fading(self) -> None:
        """New Rician K per local training round (Sec. IV)."""
        self.k_db = self.rng.uniform(*self.params.k_db_range, self.n)

    def move(self, dt: float | None = None) -> None:
        """Random-direction step, reflected into the cell (per local epoch)."""
        dt = self.epoch_seconds if dt is None else dt
        p = self.params
        step = self.rng.standard_normal((self.n, 3))
        step /= np.maximum(np.linalg.norm(step, axis=-1, keepdims=True), 1e-9)
        self.pos = self.pos + step * self.speed_mps * dt
        rad = np.linalg.norm(self.pos[:, :2], axis=-1)
        over = rad > p.cell_radius_m
        if over.any():
            self.pos[over, :2] *= (p.cell_radius_m / rad[over])[:, None]
        self.pos[:, 2] = np.clip(self.pos[:, 2], *p.uav_z_range)

    def rates(self, bandwidth_ratio: float = 1.0) -> np.ndarray:
        """Current per-UAV uplink rate, bits/s (eq. 7)."""
        return rate_bps(self.pos, self.k_db, self.params, bandwidth_ratio)

    def outages(self) -> np.ndarray:
        """Advance the interruption chain one epoch and return the state."""
        p = self.params
        go_bad, stay_bad = outage_transitions(p.outage_prob,
                                              p.outage_persistence)
        u = self.rng.random(self.n)
        self._bad = np.where(self._bad, u < stay_bad, u < go_bad)
        return self._bad.copy()
