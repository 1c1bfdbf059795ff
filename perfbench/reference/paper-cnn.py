"""Plain reference of the ``paper-cnn`` configuration: one (simulation,
config) row of an OPT-HSFL sweep (arXiv 2306.09484, Algs. 1-2), round by
round, in float32 with TF32 off.

It takes the row's draws from ``perfbench.inputs.PanelStream`` (the
benchmark's stream, which the program gets too) and its data from its own
frozen copy of the port's data derivation (``make_digits``, the
partitions, the UAVs' compute rates).  The control plane's arithmetic
(channel eqs. 1-7, the latency and energy terms of eqs. 9-13, the greedy
selection, the probe schedule and eqs. 14-16) is a copy of the port's f32
formulas, op for op, on one row's (N,) and (K,) vectors: decisions taken
on the same f32 values agree bit for bit.  The CNN trains by autograd
through ``torch.nn.functional.conv2d`` and ``torch.bmm`` (the K users as
groups), the aggregation is the masked mean of Alg. 2, and the eval is
the model's cross entropy and accuracy on the simulation's test set.

``precision="tf32"`` is the control: the same reference with every conv
and matmul operand rounded to TF32 (10 mantissa bits), and on the card
TF32 switched on for them.

Imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.inputs import PanelStream

C_LIGHT = 299_792_458.0
SCHEMES = ("opt",)          # what this reference implements


# ---------------------------------------------------------------------------
# data: a frozen copy of the port's derivation from the simulation seed
# ---------------------------------------------------------------------------

def _smooth(img, iters=2):
    for _ in range(iters):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def make_digits(n: int, seed: int, side: int = 28, num_classes: int = 10,
                noise: float = 0.8):
    """Ten prototype blobs (fixed across simulations) with per-sample
    shifts and noise, standardised: (x (n, side, side, 1) f32, y (n,))."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(1234)
    protos = np.stack([
        _smooth((proto_rng.random((side, side)) < 0.18).astype(np.float32),
                4) * 3.0 for _ in range(num_classes)])
    y = rng.integers(0, num_classes, n)
    shifts = rng.integers(-3, 4, (n, 2))
    xs = np.empty((n, side, side, 1), np.float32)
    for i in range(n):
        img = np.roll(protos[y[i]], tuple(shifts[i]), (0, 1))
        img = img + rng.standard_normal((side, side)).astype(np.float32) \
            * noise
        xs[i, :, :, 0] = img
    mean, std = xs.mean(), xs.std() + 1e-6
    return ((xs - mean) / std).astype(np.float32), y.astype(np.int32)


def partition(y: np.ndarray, n_clients: int, dist: str,
              seed: int) -> List[np.ndarray]:
    """Index sets of the clients: iid (uniform split) or noniid (2 classes
    a client, class pools sliced round robin)."""
    rng = np.random.default_rng(seed)
    if dist == "iid":
        return list(np.array_split(rng.permutation(len(y)), n_clients))
    if dist != "noniid":
        raise NotImplementedError(f"distribution {dist!r}")
    classes = np.unique(y)
    pools = {c: rng.permutation(np.where(y == c)[0]) for c in classes}
    picks = [[classes[((i * 2) % len(classes) + j) % len(classes)]
              for j in range(2)] for i in range(n_clients)]
    rng.shuffle(picks)
    uses = {c: sum(c in row for row in picks) for c in classes}
    cursor = {c: 0 for c in classes}
    out = []
    for row in picks:
        idx = []
        for c in row:
            share = len(pools[c]) // max(uses[c], 1)
            idx.append(pools[c][cursor[c]:cursor[c] + share])
            cursor[c] += share
        out.append(np.concatenate(idx))
    return out


def sim_data(cfg: Dict, seed: int, dist: str, device) -> Dict:
    """One simulation's clients (padded to the longest), compute rates,
    sample counts and test set, on ``device``."""
    h = cfg["hsfl"]
    rng = np.random.default_rng(seed)
    x, y = make_digits(h["n_train"] + h["n_test"], seed,
                       cfg["model"]["image_side"], cfg["model"]["classes"])
    parts = partition(y[:h["n_train"]], h["n_uavs"], dist, seed)
    flops = [float(rng.uniform(*h["flops_range"])) for _ in range(h["n_uavs"])]
    m = max(len(p) for p in parts)
    cx = np.zeros((h["n_uavs"], m) + x.shape[1:], np.float32)
    cy = np.zeros((h["n_uavs"], m), np.int64)
    for i, p in enumerate(parts):
        cx[i, :len(p)] = x[p]
        cy[i, :len(p)] = y[p]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    return {"client_x": t(cx), "client_y": t(cy),
            "client_len": t(np.array([len(p) for p in parts], np.int64)),
            "flops": t(np.array(flops, np.float32)),
            "samples": t(np.array([len(p) for p in parts], np.float32)),
            "test_x": t(x[h["n_train"]:]),
            "test_y": t(y[h["n_train"]:].astype(np.int64))}


# ---------------------------------------------------------------------------
# the control plane: the port's f32 arithmetic on one row
# ---------------------------------------------------------------------------

class Channel:
    """Table I, from the configuration's ``channel``."""

    def __init__(self, d: Dict):
        self.__dict__.update(d)
        self.k_db_range = tuple(d["k_db_range"])
        self.uav_z_range = tuple(d["uav_z_range"])


def _dbm_to_watt(dbm):
    return 10.0 ** (dbm / 10.0) * 1e-3


def _rate_bps(pos, k_db, p: Channel, bw_ratio):
    """eqs. (1)-(7): Shannon rate of each UAV, bits/s."""
    dz = pos[..., 2] - p.bs_height_m
    dist = torch.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2 + dz ** 2)
    d = torch.clamp_min(dist, 1.0)
    de = torch.clamp_min(dist, 1e-6)
    theta = torch.rad2deg(torch.arcsin(torch.abs(pos[..., 2] - p.bs_height_m)
                                       / de))
    plos = 1.0 / (1.0 + p.a0 * torch.exp(-p.b0 * (theta - p.a0)))
    fspl = 20.0 * torch.log10(4.0 * np.pi * d * p.carrier_hz / C_LIGHT)
    eta_los = min(p.eta_los_db, p.eta_nlos_db)
    eta_nlos = max(p.eta_los_db, p.eta_nlos_db)
    pl_db = -fspl - (plos * eta_los + (1.0 - plos) * eta_nlos)
    k_lin = 10.0 ** (k_db / 10.0)
    v = torch.sqrt(k_lin / (k_lin + 1.0))
    s = torch.sqrt(1.0 / (2.0 * (k_lin + 1.0)))
    gain = 10.0 ** (pl_db / 10.0) * (v + s)
    bw = bw_ratio * p.bandwidth_uav_hz
    noise_w = _dbm_to_watt(p.noise_dbm_per_hz + 10.0 * torch.log10(bw))
    snr = gain * _dbm_to_watt(p.p_uav_dbm) / noise_w
    return bw * torch.log2(1.0 + snr)


def _fleet_init(draws, p: Channel):
    u_r, u_ang, z, k_db, u_bad = draws
    r = p.cell_radius_m * torch.sqrt(u_r)
    ang = u_ang * 2.0 * np.pi
    pos = torch.stack([r * torch.cos(ang), r * torch.sin(ang), z], dim=-1)
    return pos, k_db, u_bad < p.outage_prob


def _move(pos, p: Channel, speed, dt, step):
    step = step / torch.clamp_min(
        torch.sqrt(torch.sum(step * step, dim=-1, keepdim=True)), 1e-9)
    pos = pos + step * speed * dt
    xy = pos[..., :2]
    rad = torch.clamp_min(torch.sqrt(torch.sum(xy * xy, dim=-1)), 1e-9)
    scale = torch.where(rad > p.cell_radius_m, p.cell_radius_m / rad, 1.0)
    z = torch.clamp(pos[..., 2:], *p.uav_z_range)
    return torch.cat([xy * scale[..., None], z], dim=-1)


def _outage(bad, p: Channel, u):
    stay = min(max(float(p.outage_persistence), 0.0), 1.0)
    go = float(p.outage_prob) * (1.0 - stay) / max(1.0 - float(p.outage_prob),
                                                   1e-9)
    go = min(max(go, 0.0), 1.0)
    return torch.where(bad, u < stay, u < go)


def _latency_energy(r, flops, samples, b, mb, ue_mb, e, c):
    """eqs. (9)-(13) for the N users: (fl_lat, sl_lat, fl_en, sl_en,
    tt_fl, tt_sl)."""
    r0 = torch.clamp_min(r, 1e-9)
    fps, uf = c["flops_per_sample"], c["ue_fraction"]
    tt_fl = e * samples * fps / flops
    tt_sl = e * samples * (uf * fps / flops
                           + (1.0 - uf) * fps / c["server_flops_per_sec"])
    act = c["act_bytes_per_sample"] * samples
    up_fl = b * mb * 8.0 / r0
    up_sl = (b * ue_mb + act) * 8.0 / r0
    dl_sl = (ue_mb + act) * 8.0 / c["bs_rate_bps"]
    fl_lat = tt_fl + up_fl
    sl_lat = tt_sl + up_sl + dl_sl
    fl_en = tt_fl * c["power_compute_w"] + up_fl * c["power_tx_w"]
    ue_t = e * samples * uf * fps / flops
    sl_en = ue_t * c["power_compute_w"] + up_sl * c["power_tx_w"]
    return fl_lat, sl_lat, fl_en, sl_en, tt_fl, tt_sl


def _select(rates0, flops, samples, b, tau, k, mb, ue_mb, e, c):
    """Alg. 1 l. 3-5: the greedy over the users in order of samples per
    joule (a stable sort), FL or SL by the lower energy (FL on a tie), at
    most ``max_sl`` SL users.  Returns (sel (K,), mode_sl (K,), valid (K,),
    n_taken, tt_fl, tt_sl); empty slots point at user 0."""
    fl_lat, sl_lat, fl_en, sl_en, tt_fl, tt_sl = _latency_energy(
        rates0, flops, samples, b, mb, ue_mb, e, c)
    feas_fl = (fl_lat <= tau).cpu().numpy()
    feas_sl = (sl_lat <= tau).cpu().numpy()
    best = torch.minimum(torch.where(torch.from_numpy(feas_fl).to(fl_en.device),
                                     fl_en, torch.inf),
                         torch.where(torch.from_numpy(feas_sl).to(sl_en.device),
                                     sl_en, torch.inf))
    util = torch.where(torch.from_numpy(feas_fl | feas_sl).to(best.device),
                       samples / torch.clamp_min(best, 1e-9), -torch.inf)
    util = util.cpu().numpy()
    sl_cheaper = (sl_en < fl_en).cpu().numpy()
    max_sl = c["max_sl"] if c["max_sl"] is not None else k // 2
    taken, modes = [], []
    for i in np.argsort(-util, kind="stable"):
        if len(taken) == k or not (feas_fl[i] or feas_sl[i]):
            continue
        prefer_sl = feas_sl[i] and (not feas_fl[i] or sl_cheaper[i])
        sl_full = sum(modes) >= max_sl
        if prefer_sl and not sl_full:
            taken.append(int(i))
            modes.append(True)
        elif feas_fl[i] and (not prefer_sl or sl_full):
            taken.append(int(i))
            modes.append(False)
    n = len(taken)
    dev = rates0.device
    sel = torch.tensor(taken + [0] * (k - n), dtype=torch.int64, device=dev)
    mode_sl = torch.tensor(modes + [False] * (k - n), device=dev)
    valid = torch.arange(k, device=dev) < n
    return sel, mode_sl, valid, n, tt_fl, tt_sl


def _probe_scheduled(e_t: int, e: int, b) -> bool:
    """Alg. 2 l. 12: a probe at e_t ≡ 0 (mod round(e/b)), e_t < e, e_t ≤
    (b-1)·period."""
    bf = torch.as_tensor(b, dtype=torch.float32)
    period = torch.clamp(torch.round(e / torch.clamp_min(bf, 1.0)), 1.0,
                         float(e))
    et = float(e_t)
    return bool((torch.remainder(et, period) == 0) & (et < e)
                & (et <= (bf - 1.0) * period))


# ---------------------------------------------------------------------------
# the CNN: K users at once, NHWC images and HWIO weights as the port's
# ---------------------------------------------------------------------------

class _RoundTF32(torch.autograd.Function):
    """Round to TF32's 10-bit mantissa (nearest, ties away from zero);
    the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & -0x2000).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def _op(x, tf32: bool):
    return _RoundTF32.apply(x) if tf32 else x


def cnn_forward(p: Dict, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Stacked params (leaves (K, ...)), images (K, B, H, W, 1) ->
    logits (K, B, classes): 3x3 SAME convs with ReLU and 2x2 max pools,
    then fc 784-128-64-classes."""
    k, bsz, h, w, _ = x.shape
    a = x.permute(1, 0, 4, 2, 3).reshape(bsz, -1, h, w)          # (B, K·C, H, W)
    for name in ("conv1", "conv2"):
        wt = p[name]["w"]                                        # (K, 3, 3, I, O)
        o = wt.shape[-1]
        wt = wt.permute(0, 4, 3, 1, 2).reshape(k * o, wt.shape[3], 3, 3)
        a = F.conv2d(_op(a, tf32), _op(wt, tf32), p[name]["b"].reshape(-1),
                     padding=1, groups=k)
        a = F.max_pool2d(torch.relu(a), 2)
    c, hh, ww = a.shape[1] // k, a.shape[2], a.shape[3]
    a = a.reshape(bsz, k, c, hh, ww).permute(1, 0, 3, 4, 2).reshape(k, bsz, -1)
    for name in ("fc1", "fc2", "fc3"):
        a = torch.bmm(_op(a, tf32), _op(p[name]["w"], tf32)) \
            + p[name]["b"][:, None]
        if name != "fc3":
            a = torch.relu(a)
    return a


def sgd_step(p: Dict, xs: torch.Tensor, ys: torch.Tensor, lr: float,
             tf32: bool = False) -> Dict:
    """One SGD step of each of the K users on its own mean cross entropy."""
    leaves = [(n, t, v.detach().requires_grad_()) for n in sorted(p)
              for t, v in sorted(p[n].items())]
    q = {}
    for n, t, v in leaves:
        q.setdefault(n, {})[t] = v
    with torch.enable_grad():
        logits = cnn_forward(q, xs, tf32)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               ys.reshape(-1), reduction="none")
        loss = loss.reshape(ys.shape).mean(dim=1).sum()
        grads = torch.autograd.grad(loss, [v for _, _, v in leaves])
    out = {}
    for (n, t, v), g in zip(leaves, grads):
        out.setdefault(n, {})[t] = v.detach() - g * lr
    return out


@contextlib.contextmanager
def _precision(tf32: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _tmap(fn, *trees):
    return {n: {t: fn(*(tr[n][t] for tr in trees)) for t in trees[0][n]}
            for n in trees[0]}


# ---------------------------------------------------------------------------
# one row
# ---------------------------------------------------------------------------

@torch.no_grad()
def run_row(cfg: Dict, scheme: str, rounds: int, seed: int, dist: str,
            b: float, tau_max: float, bw_ratio: float, device,
            precision: str = "f32") -> Dict:
    """Simulate one (simulation, config) row for ``rounds`` rounds.
    Returns per-round ``selected``, ``arrived``, ``rescued``, ``delayed``,
    ``dropped``, ``bytes_sent``, ``test_loss``, ``test_acc`` (numpy,
    (rounds,)) and the global ``params`` after the last round."""
    if scheme not in SCHEMES:
        raise NotImplementedError(f"the reference implements {SCHEMES}, "
                                  f"not {scheme!r}")
    tf32 = precision == "tf32"
    h, c, p = cfg["hsfl"], cfg["round"], Channel(cfg["channel"])
    k, n_users, e = h["k_select"], h["n_uavs"], h["local_epochs"]
    steps, bsz, lr = h["steps_per_epoch"], h["batch_size"], h["lr"]
    mb = h["model_bytes"] * h["compress_ratio"]
    ue_mb = mb * h["ue_model_fraction"]
    data = sim_data(cfg, seed, dist, device)
    stream = PanelStream(seed, device, cfg["model"]["param_shapes"])
    params = stream.init_params()
    pos, k_db, bad = _fleet_init(stream.fleet_init_draws(n_users, p), p)
    bt = torch.tensor(float(b), dtype=torch.float32, device=device)
    tau_t = torch.tensor(float(tau_max), dtype=torch.float32, device=device)
    bw = torch.tensor(float(bw_ratio), dtype=torch.float32, device=device)
    hist = {f: [] for f in ("selected", "arrived", "rescued", "delayed",
                            "dropped", "bytes_sent", "test_loss",
                            "test_acc")}
    with _precision(tf32):
        for _ in range(rounds):
            k_db = stream.fleet_uniform(n_users, *p.k_db_range)
            rates0 = _rate_bps(pos, k_db, p, bw)
            sel, mode_sl, valid, n_taken, tt_fl, tt_sl = _select(
                rates0, data["flops"], data["samples"], bt, tau_t, k, mb,
                ue_mb, e, c)
            train_time = torch.where(valid, torch.where(mode_sl, tt_sl[sel],
                                                        tt_fl[sel]), 1e9)
            payload_bits = torch.where(mode_sl, ue_mb, mb) * 8.0
            tau_extra0 = torch.clamp_min(bt - 1.0, 0.0) * payload_bits \
                / torch.clamp_min(rates0[sel], 1e-9)
            users = _tmap(lambda a: a.unsqueeze(0).repeat(
                (k,) + (1,) * a.dim()), params)
            snap = _tmap(torch.clone, users)
            has_snap = torch.zeros(k, dtype=torch.bool, device=device)
            nsent = torch.zeros(k, dtype=torch.int32, device=device)
            tau_extra = tau_extra0
            clen = torch.clamp_min(data["client_len"][sel], 1)
            for e_t in range(1, e + 1):
                pos = _move(pos, p, c["speed_mps"], c["epoch_seconds"],
                            stream.fleet_normal((n_users, 3)))
                rate_e = _rate_bps(pos, k_db, p, bw)[sel]
                bad = _outage(bad, p, stream.fleet_uniform(n_users))
                out_e = bad[sel]
                idx = stream.batch_indices(0, e_t, clen[None],
                                           steps * bsz)[0]      # (K, n)
                xs = data["client_x"][sel[:, None], idx]          # (K, n, ...)
                ys = data["client_y"][sel[:, None], idx]
                xs = xs.reshape(k, steps, bsz, *xs.shape[2:])
                ys = ys.reshape(k, steps, bsz)
                for s in range(steps):
                    users = sgd_step(users, xs[:, s], ys[:, s], lr, tf32)
                if _probe_scheduled(e_t, e, bt):
                    tau = payload_bits / torch.clamp_min(rate_e, 1e-9)
                    ok = valid & ~out_e & (tau <= tau_extra)
                    tau_extra = torch.where(ok, tau_extra - tau, tau_extra)
                    snap = _tmap(lambda u, s_: torch.where(
                        ok.reshape((k,) + (1,) * (u.dim() - 1)), u, s_),
                        users, snap)
                    has_snap = has_snap | ok
                    nsent = nsent + ok.to(torch.int32)
            rate_f = _rate_bps(pos, k_db, p, bw)[sel]
            bad = _outage(bad, p, stream.fleet_uniform(n_users))
            tau_f = payload_bits / torch.clamp_min(rate_f, 1e-9)
            fits = train_time + tau_extra0 * 0.0 + tau_f <= tau_t
            arrived = valid & ~bad[sel] & fits
            rescued = ~arrived & has_snap
            w = (arrived | rescued).to(torch.float32)
            den = torch.sum(w)

            def agg(u, s_, g):
                kw = w.reshape((k,) + (1,) * (u.dim() - 1))
                a = torch.where(kw > 0, torch.where(
                    arrived.reshape(kw.shape), u, s_), 0.0)
                return torch.where(den > 0, torch.sum(a * kw, dim=0)
                                   / torch.where(den > 0, den, 1.0), g)

            params = _tmap(agg, users, snap, params)
            dropped = valid & ~arrived & ~rescued
            events = nsent + arrived.to(torch.int32)
            bytes_sent = torch.sum(torch.where(valid, payload_bits / 8.0
                                               * events, 0.0))
            act = c["act_bytes_per_sample"] * data["samples"][sel]
            bytes_sent = bytes_sent + torch.sum(
                torch.where(valid & mode_sl & (events > 0), act, 0.0))
            n_test = data["test_y"].shape[0]
            logits = cnn_forward(_tmap(lambda a: a[None], params),
                                 data["test_x"][None], tf32)[0]
            loss = F.cross_entropy(logits, data["test_y"], reduction="sum")
            hits = torch.sum(torch.argmax(logits, -1) == data["test_y"])
            for f, v in (("selected", n_taken),
                         ("arrived", int(arrived.sum())),
                         ("rescued", int(rescued.sum())), ("delayed", 0),
                         ("dropped", int(dropped.sum())),
                         ("bytes_sent", float(bytes_sent)),
                         ("test_loss", float(loss) / n_test),
                         ("test_acc", float(hits) / n_test)):
                hist[f].append(v)
    out = {f: np.asarray(v) for f, v in hist.items()}
    out["params"] = params
    return out

