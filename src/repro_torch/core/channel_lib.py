"""Wireless channel core, Section II-A eqs. (1)–(7)
(``repro/core/channel_lib.py``).

Every equation takes ``xp``: numpy (f64) for the host reference
``UAVFleet`` of ``core/channel.py``, or torch on f32 tensors for the
device path, as the reference computes its jax half in f32; the torch
forms broadcast over any leading axes (simulations, configs).

``FleetState`` is the device fleet (positions, Rician K, the
Gilbert–Elliott outage state) that the on-device round
(``core/fused_round.build_device_round``) carries from round to round.
Its transitions take their random draws as arguments; the draws come
from the simulation's stream (``core/streams.py``), in the order the
reference's fleet consumes its key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

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


def _at_least(x, lo: float, xp):
    """max(x, lo) elementwise (``torch.maximum`` takes no number)."""
    return torch.clamp_min(x, lo) if xp is torch else xp.maximum(x, lo)


def distance(pos, bs_height: float, xp=np):
    """eq. (1).  pos: (..., 3) UAV coordinates; BS at (0, 0, z0)."""
    dz = pos[..., 2] - bs_height
    return xp.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2 + dz ** 2)


def elevation_deg(pos, bs_height: float, xp=np):
    """eq. (2), degrees in [0, 90)."""
    d = _at_least(distance(pos, bs_height, xp), 1e-6, xp)
    rad = xp.arcsin(xp.abs(pos[..., 2] - bs_height) / d)
    return torch.rad2deg(rad) if xp is torch else xp.degrees(rad)


def p_los(theta_deg, p: ChannelParams, xp=np):
    """eq. (3)."""
    return 1.0 / (1.0 + p.a0 * xp.exp(-p.b0 * (theta_deg - p.a0)))


def path_loss_db(pos, p: ChannelParams, xp=np):
    """eq. (4) (negative dB = attenuation): Friis FSPL plus the
    P_LOS-weighted expected additional loss."""
    d = _at_least(distance(pos, p.bs_height_m, xp), 1.0, xp)
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
    """eq. (7): Shannon rate in bits/s for allocated bandwidth n_i·B_uav
    (with ``xp=torch``, ``bandwidth_ratio`` is a tensor, e.g. a config
    axis that broadcasts against ``k_db``)."""
    bw = bandwidth_ratio * p.bandwidth_uav_hz
    noise_w = dbm_to_watt(p.noise_dbm_per_hz + 10.0 * xp.log10(bw))
    snr = channel_gain(pos, k_db, p, xp) * dbm_to_watt(p.p_uav_dbm) / noise_w
    return bw * xp.log2(1.0 + snr)


# ---------------------------------------------------------------------------
# the device fleet
# ---------------------------------------------------------------------------

class FleetState(NamedTuple):
    """The device fleet (Section IV dynamics), f32 tensors with any leading
    axes (the device round keeps one fleet per simulation, (S, N)).
    Unlike the reference it holds no key: every transition takes its draws
    from the simulation's stream."""
    pos: torch.Tensor       # (..., N, 3) UAV coordinates
    k_db: torch.Tensor      # (..., N) Rician factor, dB
    bad: torch.Tensor       # (..., N) bool Gilbert–Elliott outage state


def fleet_init(draws, p: ChannelParams) -> FleetState:
    """Uniform-in-disk xy, uniform z, uniform K, outage state at the
    stationary marginal.  ``draws`` = (u_r, u_ang, z, k_db, u_bad): the
    five draws of the reference's ``fleet_init`` (``streams`` makes them:
    u_* uniform in [0, 1), z and k_db already in their ranges)."""
    u_r, u_ang, z, k_db, u_bad = draws
    r = p.cell_radius_m * torch.sqrt(u_r)
    ang = u_ang * 2.0 * np.pi
    pos = torch.stack([r * torch.cos(ang), r * torch.sin(ang), z], dim=-1)
    return FleetState(pos=pos, k_db=k_db, bad=u_bad < p.outage_prob)


def fleet_resample_fading(state: FleetState, k_db: torch.Tensor
                          ) -> FleetState:
    """New Rician K per local training round (Sec. IV): ``k_db`` drawn
    uniform in ``ChannelParams.k_db_range``."""
    return state._replace(k_db=k_db)


def fleet_move(state: FleetState, p: ChannelParams, speed_mps: float,
               dt: float, step: torch.Tensor) -> FleetState:
    """Random-direction step of ``speed_mps·dt`` metres along the standard
    normal ``step`` (..., N, 3), reflected into the cell (per epoch)."""
    step = step / torch.clamp_min(
        torch.sqrt(torch.sum(step * step, dim=-1, keepdim=True)), 1e-9)
    pos = state.pos + step * speed_mps * dt
    xy = pos[..., :2]
    rad = torch.clamp_min(torch.sqrt(torch.sum(xy * xy, dim=-1)), 1e-9)
    scale = torch.where(rad > p.cell_radius_m, p.cell_radius_m / rad, 1.0)
    z = torch.clamp(pos[..., 2:], *p.uav_z_range)
    return state._replace(pos=torch.cat([xy * scale[..., None], z], dim=-1))


def fleet_outage_step(state: FleetState, p: ChannelParams, u: torch.Tensor):
    """Advance the Gilbert–Elliott chain one epoch on uniform draws ``u``;
    returns (state, bad)."""
    go_bad, stay_bad = outage_transitions(p.outage_prob, p.outage_persistence)
    bad = torch.where(state.bad, u < stay_bad, u < go_bad)
    return state._replace(bad=bad), bad


def fleet_rates(state: FleetState, p: ChannelParams,
                bandwidth_ratio: torch.Tensor) -> torch.Tensor:
    """Current per-UAV uplink rate, bits/s (eq. 7)."""
    return rate_bps(state.pos, state.k_db, p, bandwidth_ratio, xp=torch)
