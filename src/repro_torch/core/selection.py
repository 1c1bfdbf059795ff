"""User selection + FL/SL scheduling, Alg. 1 lines 3–5
(``repro/core/selection.py``).

``schedule_users`` is the host greedy the fused round runs every round;
``user_latency_energy`` is its vectorized eqs. (9)–(13) (numpy or torch);
``select_users_device`` is the same greedy on the device, the counterpart
of the reference's ``select_users_jax``, over a leading batch axis G of
(simulation, config) rows whose b, τ_max and rates differ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

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
    r0 = (torch.clamp_min(rates0, 1e-9) if xp is torch
          else xp.maximum(rates0, 1e-9))
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


def _rows(v, g: int, device) -> torch.Tensor:
    """A per-row scalar (float, 0-d or (G,) tensor) as a (G, 1) f32 column
    (a Python number becomes a fill on ``device``, never a copy)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((g, 1), float(v), device=device)
    return v.to(torch.float32).reshape(-1, 1).expand(g, 1)


def select_users_device(rates0, flops, samples, *, b, tau_max,
                        k_select: int, model_bytes: float,
                        ue_model_bytes: float, local_epochs: int,
                        max_sl: int | None = None, **lat_kw) -> Tuple:
    """``schedule_users`` on the device for G rows at once.

    rates0, flops, samples: (G, N) f32 (or (N,) for one row); ``b`` and
    ``tau_max`` per row ((G,) tensors or scalars).  Returns fixed-width
    slot arrays: ``sel`` (G, K) int64 user indices in greedy order,
    ``mode_sl`` (G, K) bool, ``valid`` (G, K) bool (slot occupied),
    ``n_taken`` (G,) int32, and ``tt_fl``/``tt_sl`` (G, N) training times.
    Invalid slots point at user 0.  The greedy walks the N users in
    utility order (a stable sort of −utility, infeasible users at −inf),
    one step per user on (G,) vectors; on an fl_en == sl_en tie it takes
    FL.  No value is read back to the host.
    """
    one = rates0.dim() == 1
    if one:
        rates0, flops, samples = rates0[None], flops[None], samples[None]
    if max_sl is None:
        max_sl = k_select // 2
    g, n = rates0.shape
    dev = rates0.device
    b_col, tau_col = _rows(b, g, dev), _rows(tau_max, g, dev)
    fl_lat, sl_lat, fl_en, sl_en, tt_fl, tt_sl = user_latency_energy(
        rates0, flops, samples, b=b_col, model_bytes=model_bytes,
        ue_model_bytes=ue_model_bytes, local_epochs=local_epochs,
        xp=torch, **lat_kw)

    feas_fl = fl_lat <= tau_col
    feas_sl = sl_lat <= tau_col
    feas_any = feas_fl | feas_sl
    inf = torch.inf
    best_en = torch.minimum(torch.where(feas_fl, fl_en, inf),
                            torch.where(feas_sl, sl_en, inf))
    utility = torch.where(feas_any,
                          samples / torch.clamp_min(best_en, 1e-9), -inf)
    order = torch.argsort(-utility, dim=1, stable=True)
    prefer_sl = feas_sl & (~feas_fl | (sl_en < fl_en))

    # the greedy, one user at a time in utility order
    p_sl = torch.gather(prefer_sl, 1, order)
    f_fl = torch.gather(feas_fl, 1, order)
    f_any = torch.gather(feas_any, 1, order)
    cnt = torch.zeros(g, dtype=torch.int32, device=dev)
    slu = torch.zeros(g, dtype=torch.int32, device=dev)
    take, take_sl = [], []
    for i in range(n):
        room = cnt < k_select
        capped = slu >= max_sl
        t_sl = p_sl[:, i] & ~capped
        t_fl = f_fl[:, i] & (~p_sl[:, i] | capped)
        tk = room & f_any[:, i] & (t_sl | t_fl)
        t_sl = tk & t_sl
        cnt = cnt + tk.to(torch.int32)
        slu = slu + t_sl.to(torch.int32)
        take.append(tk)
        take_sl.append(t_sl)
    take = torch.stack(take, dim=1)
    take_sl = torch.stack(take_sl, dim=1)

    # pack the taken users (greedy order) into K fixed slots (n may be < K)
    rank = torch.cumsum(take.to(torch.int64), dim=1) - 1
    slot_key = torch.where(take, rank, n + 1)
    k_eff = min(k_select, n)
    pick = torch.argsort(slot_key, dim=1, stable=True)[:, :k_eff]
    sel = torch.zeros((g, k_select), dtype=torch.int64, device=dev)
    mode_sl = torch.zeros((g, k_select), dtype=torch.bool, device=dev)
    sel[:, :k_eff] = torch.gather(order, 1, pick)
    mode_sl[:, :k_eff] = torch.gather(take_sl, 1, pick)
    valid = torch.arange(k_select, device=dev)[None] < cnt[:, None]
    sel = torch.where(valid, sel, 0)
    out = (sel, mode_sl & valid, valid, cnt, tt_fl, tt_sl)
    return tuple(o[0] for o in out) if one else out
