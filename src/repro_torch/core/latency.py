"""One-round latency accounting — Section III-A, eqs. (9)–(16).

FL users:  τ_iF = τ_tr + τ_ul            (eq. 9),  τ_ul = b·m_g / r⁰   (eq. 13)
SL users:  τ_iS = τ_tr + τ_ul + τ_dl     (eq. 10), τ_ul = (b·m_l + m_a)/r⁰
Extra opportunistic allowance: τ_extra = (b−1)·m / r⁰            (eq. 14)
Real-time snapshot delay:      τ^{e_t}  = m / r^{e_t}            (eq. 15)

Training/downlink terms follow [6]'s structure (per-sample FLOPs over device
compute rate); [6]'s exact constants are not in this paper, so they are
explicit dataclass fields here.
"""
from __future__ import annotations

from dataclasses import dataclass



@dataclass
class DeviceProfile:
    """Per-UAV compute/energy profile (heterogeneous fleet)."""
    flops_per_sec: float = 5.0e9          # UAV on-board compute
    server_flops_per_sec: float = 1.0e12  # BS edge server
    power_compute_w: float = 5.0          # UAV compute power draw
    power_tx_w: float = 0.25              # 24 dBm transmit power


@dataclass
class WorkloadProfile:
    """Learning-task constants used by the latency terms."""
    flops_per_sample: float = 2.0e6       # fwd+bwd of the 5-layer CNN
    ue_fraction: float = 0.4              # fraction of FLOPs on UE side (SL)
    local_epochs: int = 6
    samples: int = 200                    # |D_i|
    act_bytes_per_sample: float = 3136.0  # cut-layer activation (m_a / |D_i|)


def train_time_fl(dev: DeviceProfile, wl: WorkloadProfile) -> float:
    """τ_tr for an FL user: all epochs on the UAV."""
    return wl.local_epochs * wl.samples * wl.flops_per_sample / dev.flops_per_sec


def train_time_sl(dev: DeviceProfile, wl: WorkloadProfile) -> float:
    """τ_tr for an SL user: UE front + BS back per epoch."""
    ue = wl.ue_fraction * wl.flops_per_sample / dev.flops_per_sec
    bs = (1 - wl.ue_fraction) * wl.flops_per_sample / dev.server_flops_per_sec
    return wl.local_epochs * wl.samples * (ue + bs)


def uplink_fl(b: int, model_bytes: float, rate_bps: float) -> float:
    """eq. (13) left: b·m_g / r⁰ (seconds)."""
    return b * model_bytes * 8.0 / max(rate_bps, 1e-9)


def uplink_sl(b: int, ue_model_bytes: float, act_bytes: float,
              rate_bps: float) -> float:
    """eq. (13) right: (b·m_l + m_a) / r⁰."""
    return (b * ue_model_bytes + act_bytes) * 8.0 / max(rate_bps, 1e-9)


def downlink_sl(bs_rate_bps: float, ue_model_bytes: float, act_bytes: float) -> float:
    """τ_dl: BS returns the UE-side model + cut-layer gradients."""
    return (ue_model_bytes + act_bytes) * 8.0 / max(bs_rate_bps, 1e-9)


def one_round_latency_fl(dev: DeviceProfile, wl: WorkloadProfile, b: int,
                         model_bytes: float, rate_bps: float) -> float:
    """eq. (9) with relaxed uplink (eq. 13)."""
    return train_time_fl(dev, wl) + uplink_fl(b, model_bytes, rate_bps)


def one_round_latency_sl(dev: DeviceProfile, wl: WorkloadProfile, b: int,
                         ue_model_bytes: float, rate_bps: float,
                         bs_rate_bps: float) -> float:
    """eq. (10) with relaxed uplink (eq. 13)."""
    act = wl.act_bytes_per_sample * wl.samples
    return (train_time_sl(dev, wl)
            + uplink_sl(b, ue_model_bytes, act, rate_bps)
            + downlink_sl(bs_rate_bps, ue_model_bytes, act))


def extra_allowance(b: int, model_bytes: float, rate_bps: float) -> float:
    """eq. (14): τ_extra = (b−1)·m / r⁰."""
    return (b - 1) * model_bytes * 8.0 / max(rate_bps, 1e-9)


def snapshot_delay(model_bytes: float, rate_bps: float) -> float:
    """eq. (15): τ^{e_t} = m / r^{e_t}."""
    return model_bytes * 8.0 / max(rate_bps, 1e-9)


def energy_fl(dev: DeviceProfile, wl: WorkloadProfile, tx_seconds: float) -> float:
    """Joules: compute + transmit (used by the greedy selector's utility)."""
    return (train_time_fl(dev, wl) * dev.power_compute_w
            + tx_seconds * dev.power_tx_w)


def energy_sl(dev: DeviceProfile, wl: WorkloadProfile, tx_seconds: float) -> float:
    ue_t = (wl.local_epochs * wl.samples * wl.ue_fraction
            * wl.flops_per_sample / dev.flops_per_sec)
    return ue_t * dev.power_compute_w + tx_seconds * dev.power_tx_w
