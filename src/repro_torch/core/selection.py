"""User selection + FL/SL scheduling, Alg. 1 lines 3–5 (a copy of the host
side of ``repro/core/selection.py``).

``schedule_users`` is the host greedy the fused round runs every round;
``user_latency_energy`` is its vectorized eqs. (9)–(13).  The on-device
``select_users_jax`` twin waits for the device-round slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core import latency as lat


@dataclass
class ScheduledUser:
    index: int
    mode: str                  # "FL" | "SL"
    latency_s: float
    energy_j: float
    rate0_bps: float


def schedule_users(rates0: Sequence[float],
                   devices: Sequence[lat.DeviceProfile],
                   workloads: Sequence[lat.WorkloadProfile],
                   model_bytes: float, ue_model_bytes: float,
                   b: int, tau_max: float, k_select: int,
                   bs_rate_bps: float = 400e6,
                   max_sl: int | None = None) -> List[ScheduledUser]:
    """Greedy selection of ≤ k_select users with FL/SL assignment.

    ``max_sl`` caps SL slots (default: half of k_select).  The sorts are
    Python's, which are stable: equal utilities keep fleet order.
    """
    if max_sl is None:
        max_sl = k_select // 2
    candidates = []
    for i, (r0, dev, wl) in enumerate(zip(rates0, devices, workloads)):
        fl_lat = lat.one_round_latency_fl(dev, wl, b, model_bytes, r0)
        sl_lat = lat.one_round_latency_sl(dev, wl, b, ue_model_bytes, r0,
                                          bs_rate_bps)
        fl_en = lat.energy_fl(dev, wl, lat.uplink_fl(b, model_bytes, r0))
        act = wl.act_bytes_per_sample * wl.samples
        sl_en = lat.energy_sl(dev, wl, lat.uplink_sl(b, ue_model_bytes, act, r0))
        options = {}
        if fl_lat <= tau_max:
            options["FL"] = (fl_lat, fl_en)
        if sl_lat <= tau_max:
            options["SL"] = (sl_lat, sl_en)
        if not options:
            continue
        candidates.append((i, r0, options))

    def best_energy(c):
        return min(en for _, en in c[2].values())

    candidates.sort(key=lambda c: workloads[c[0]].samples / max(best_energy(c), 1e-9),
                    reverse=True)

    out: List[ScheduledUser] = []
    sl_used = 0
    for i, r0, options in candidates:
        if len(out) == k_select:
            break
        order = sorted(options.items(), key=lambda kv: kv[1][1])
        for mode, (l, en) in order:
            if mode == "SL" and sl_used >= max_sl:
                continue
            out.append(ScheduledUser(i, mode, l, en, r0))
            sl_used += mode == "SL"
            break
    return out


def user_latency_energy(rates0, flops, samples, *, b, model_bytes,
                        ue_model_bytes, local_epochs,
                        flops_per_sample=2.0e6, ue_fraction=0.4,
                        act_bytes_per_sample=3136.0,
                        server_flops_per_sec=1.0e12, bs_rate_bps=400e6,
                        power_compute_w=5.0, power_tx_w=0.25, xp=np):
    """Vectorized eqs. (9)–(13) for all N users at once.

    Returns (fl_lat, sl_lat, fl_en, sl_en, tt_fl, tt_sl).
    """
    r0 = xp.maximum(rates0, 1e-9)
    tt_fl = local_epochs * samples * flops_per_sample / flops
    tt_sl = local_epochs * samples * (
        ue_fraction * flops_per_sample / flops
        + (1.0 - ue_fraction) * flops_per_sample / server_flops_per_sec)
    act = act_bytes_per_sample * samples
    up_fl = b * model_bytes * 8.0 / r0
    up_sl = (b * ue_model_bytes + act) * 8.0 / r0
    dl_sl = (ue_model_bytes + act) * 8.0 / bs_rate_bps
    fl_lat = tt_fl + up_fl
    sl_lat = tt_sl + up_sl + dl_sl
    fl_en = tt_fl * power_compute_w + up_fl * power_tx_w
    ue_t = local_epochs * samples * ue_fraction * flops_per_sample / flops
    sl_en = ue_t * power_compute_w + up_sl * power_tx_w
    return fl_lat, sl_lat, fl_en, sl_en, tt_fl, tt_sl
