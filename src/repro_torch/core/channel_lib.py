"""Wireless channel core, Section II-A eqs. (1)–(7): the numpy part of
``repro/core/channel_lib.py``, copied.

The host reference ``UAVFleet`` (``core/channel.py``) binds these to numpy.
The device-side ``FleetState`` and its ``fleet_*`` transitions belong to the
on-device round and are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

C_LIGHT = 299_792_458.0


@dataclass
class ChannelParams:
    """Table I."""
    p_uav_dbm: float = 24.0
    noise_dbm_per_hz: float = -174.0
    k_db_range: Tuple[float, float] = (1.8, 5.0)
    carrier_hz: float = 2.0e9
    bandwidth_uav_hz: float = 10.0e6
    a0: float = 5.0188           # urban environment parameters
    b0: float = 0.3511
    eta_los_db: float = 21.0     # additional path loss LOS   (η_l)
    eta_nlos_db: float = 1.0     # additional path loss NLOS  (η_n)
    outage_prob: float = 0.30    # complete-interruption probability (Sec. IV)
    outage_persistence: float = 0.70   # Gilbert-Elliott stay-bad per epoch
    cell_radius_m: float = 500.0
    bs_height_m: float = 20.0
    uav_z_range: Tuple[float, float] = (20.0, 80.0)


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * 1e-3


def outage_transitions(outage_prob: float,
                       persistence: float) -> Tuple[float, float]:
    """Gilbert–Elliott (go_bad, stay_bad) for a target stationary marginal;
    go_bad is clamped to [0, 1] (it exceeds 1 as outage_prob -> 1)."""
    stay_bad = min(max(float(persistence), 0.0), 1.0)
    go_bad = float(outage_prob) * (1.0 - stay_bad) \
        / max(1.0 - float(outage_prob), 1e-9)
    return min(max(go_bad, 0.0), 1.0), stay_bad


def distance(pos, bs_height: float, xp=np):
    """eq. (1).  pos: (..., 3) UAV coordinates; BS at (0, 0, z0)."""
    dz = pos[..., 2] - bs_height
    return xp.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2 + dz ** 2)


def elevation_deg(pos, bs_height: float, xp=np):
    """eq. (2), degrees in [0, 90)."""
    d = xp.maximum(distance(pos, bs_height, xp), 1e-6)
    return xp.degrees(xp.arcsin(xp.abs(pos[..., 2] - bs_height) / d))


def p_los(theta_deg, p: ChannelParams, xp=np):
    """eq. (3)."""
    return 1.0 / (1.0 + p.a0 * xp.exp(-p.b0 * (theta_deg - p.a0)))


def path_loss_db(pos, p: ChannelParams, xp=np):
    """eq. (4) (negative dB = attenuation): Friis FSPL plus the
    P_LOS-weighted expected additional loss."""
    d = xp.maximum(distance(pos, p.bs_height_m, xp), 1.0)
    plos = p_los(elevation_deg(pos, p.bs_height_m, xp), p, xp)
    fspl = 20.0 * xp.log10(4.0 * np.pi * d * p.carrier_hz / C_LIGHT)
    eta_los = min(p.eta_los_db, p.eta_nlos_db)       # LOS suffers less
    eta_nlos = max(p.eta_los_db, p.eta_nlos_db)
    extra = plos * eta_los + (1.0 - plos) * eta_nlos
    return -fspl - extra


def channel_gain(pos, k_db, p: ChannelParams, xp=np):
    """eqs. (5)–(6): linear power gain x expected Rician amplitude (v+s)."""
    k_lin = 10.0 ** (xp.asarray(k_db) / 10.0)
    v = xp.sqrt(k_lin / (k_lin + 1.0))
    s = xp.sqrt(1.0 / (2.0 * (k_lin + 1.0)))
    return 10.0 ** (path_loss_db(pos, p, xp) / 10.0) * (v + s)


def rate_bps(pos, k_db, p: ChannelParams, bandwidth_ratio=1.0, xp=np):
    """eq. (7): Shannon rate in bits/s for allocated bandwidth n_i·B_uav."""
    bw = bandwidth_ratio * p.bandwidth_uav_hz
    noise_w = dbm_to_watt(p.noise_dbm_per_hz + 10.0 * xp.log10(bw))
    snr = channel_gain(pos, k_db, p, xp) * dbm_to_watt(p.p_uav_dbm) / noise_w
    return bw * xp.log2(1.0 + snr)
