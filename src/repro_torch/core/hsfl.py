"""The HSFL + OPT simulation, Algorithms 1 & 2 end to end
(``repro/core/hsfl.py``, fused engine).

The paper's setting (Section IV): 30 UAVs, 10 selected per round, e=6 local
epochs of 4 steps, batch 10, lr 0.01, the 5-layer CNN, a Rician channel
with per-round K resampling, per-epoch path-loss variation and a 30%
complete-interruption probability.  Each round:

1. selects users on the host through the scheme registry;
2. presamples the round's channel and batches on the host from the numpy
   streams, in exactly the reference's order (so both packages see the
   same channel, batches and decisions for the same seed);
3. runs ``build_fused_round`` on the device: local training through the
   fused-CNN kernels, the OPT probe decisions and the scheme's aggregate;
4. evaluates on the test set through the forward kernels.

``HSFLSimulation(cfg, device=None)`` runs on the CUDA card and raises when
there is none; ``device="cpu"`` runs the kernels' plain twins.  The host
reference engine (``use_fused_round=False``) and the delta codec wait for
later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import latency as lat
from repro_torch.core.channel import ChannelParams, UAVFleet
from repro_torch.core.fused_round import build_fused_round
from repro_torch.core.metrics import RoundLog, SimLog
from repro_torch.core.schemes import get_scheme
from repro_torch.data.partition import partition
from repro_torch.data.synthetic import Dataset, make_digits
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_cnn.ops import ForwardPolicy, make_eval_forward
from repro_torch.models import cnn as cnn_mod
from repro_torch.training.loss import accuracy, cross_entropy
from repro_torch.utils.tree import tree_map


@dataclass
class HSFLConfig:
    scheme: str = "opt"            # a registered scheme (core/schemes.py)
    distribution: str = "noniid"   # iid | noniid | imbalanced
    n_uavs: int = 30
    k_select: int = 10
    rounds: int = 100              # B
    local_epochs: int = 6          # e
    b: int = 2                     # transmission budget
    tau_max: float = 9.0           # seconds
    batch_size: int = 10
    lr: float = 0.01
    steps_per_epoch: int = 4       # fixed-size local epoch
    n_train: int = 6000
    n_test: int = 1000
    cut_stage: int = 2             # SL cut: conv stages on the UE
    seed: int = 0
    # nominal payload scale (keeps τ_max in the paper's 8–11 s regime)
    model_bytes: float = 10e6
    ue_model_fraction: float = 0.25
    compress_ratio: float = 1.0    # <1 when snapshots are compressed
    use_delta_codec: bool = False  # not ported yet
    codec_block: int = 512
    codec_bits: int = 8
    use_fused_round: bool = True   # False (host reference) not ported yet
    # CNN hot-path policy (kernels/fused_cnn.ForwardPolicy); xla and pallas
    # both run the port's kernels
    kernel: str = "xla"
    precision: str = "f32"
    block_k: int = 0
    batch_users: bool = True
    schedule_override: tuple = ()  # manual opportunistic schedule (Sec. III-B)
    flops_range: tuple = (0.8e8, 4e8)
    channel: ChannelParams = field(default_factory=ChannelParams)
    async_alpha: float = 0.4
    async_a: float = 0.5


def model_compress_ratio(cfg: HSFLConfig) -> float:
    """The snapshot compression ratio: ``cfg.compress_ratio`` (the codec's
    derived ratio waits for the codec slice)."""
    if cfg.use_delta_codec:
        raise NotImplementedError(
            "use_delta_codec=True is not ported yet (ROADMAP queue 1: "
            "delta codec)")
    return cfg.compress_ratio


def _heterogeneous_devices(n: int, rng: np.random.Generator,
                           flops_range=(1.5e8, 6e8)) -> List[lat.DeviceProfile]:
    return [lat.DeviceProfile(flops_per_sec=float(rng.uniform(*flops_range)))
            for _ in range(n)]


def _epoch_indices(n: int, cfg: HSFLConfig, rng: np.random.Generator) -> np.ndarray:
    """Fixed-shape (steps, bs) batch indices for one local epoch."""
    need = cfg.steps_per_epoch * cfg.batch_size
    idx = rng.permutation(n)
    while len(idx) < need:
        idx = np.concatenate([idx, rng.permutation(n)])
    return idx[:need].reshape(cfg.steps_per_epoch, cfg.batch_size)


def _k_bucket(n_sched: int, k_select: int) -> int:
    """Pad K to a small even bucket.  Padded slots hold zero images with
    label 0, are ``valid=False`` and still train, as in the reference."""
    return min(k_select, 2 * ((n_sched + 1) // 2))


class HSFLSimulation:
    """Control plane on the host around the fused device round."""

    def __init__(self, cfg: HSFLConfig, device=None):
        if not cfg.use_fused_round:
            raise NotImplementedError(
                "use_fused_round=False (the host reference engine) is not "
                "ported yet (ROADMAP queue 1: host engine)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scheme = get_scheme(cfg.scheme)
        self.rng = np.random.default_rng(cfg.seed)
        full = make_digits(cfg.n_train + cfg.n_test, seed=cfg.seed)
        self.test = Dataset(full.x[cfg.n_train:], full.y[cfg.n_train:])
        train = Dataset(full.x[:cfg.n_train], full.y[:cfg.n_train])
        self.clients = partition(train, cfg.n_uavs, cfg.distribution, cfg.seed)
        self.fleet = UAVFleet(cfg.n_uavs, cfg.channel, seed=cfg.seed + 1)
        self.devices = _heterogeneous_devices(cfg.n_uavs, self.rng,
                                              cfg.flops_range)
        self.workloads = [
            lat.WorkloadProfile(local_epochs=cfg.local_epochs,
                                samples=len(c)) for c in self.clients]
        self.params = cnn_mod.init_cnn(cfg.seed, self.device)
        self._test_x = torch.from_numpy(self.test.x).to(self.device)
        self._test_y = torch.from_numpy(self.test.y).to(self.device)
        self.compress_ratio = model_compress_ratio(cfg)
        self._probe_epochs = self.scheme.static_schedule(
            cfg.local_epochs, cfg.b, cfg.schedule_override)
        policy = ForwardPolicy(kernel=cfg.kernel, precision=cfg.precision,
                               block_k=cfg.block_k,
                               batch_users=cfg.batch_users).validate()
        self._eval_fwd = make_eval_forward(policy)
        self._fused = build_fused_round(
            scheme=self.scheme, local_epochs=cfg.local_epochs,
            steps_per_epoch=cfg.steps_per_epoch, lr=cfg.lr,
            tau_max=cfg.tau_max, probe_epochs=self._probe_epochs,
            async_weight=cfg.async_alpha * 2.0 ** (-cfg.async_a),
            k_carry=cfg.k_select, forward=policy)

    def evaluate(self) -> Tuple[float, float]:
        logits = self._eval_fwd(self.params, self._test_x)
        return (float(cross_entropy(logits, self._test_y)),
                float(accuracy(logits, self._test_y)))

    # -- per-round control plane ---------------------------------------------
    def _schedule_round(self):
        cfg = self.cfg
        self.fleet.resample_fading()           # per local-round K (Sec. IV)
        rates0 = self.fleet.rates()
        ue_bytes = cfg.model_bytes * cfg.ue_model_fraction
        sched = self.scheme.selection_policy_host(
            rates0, self.devices, self.workloads,
            cfg.model_bytes * self.compress_ratio,
            ue_bytes * self.compress_ratio, cfg.b, cfg.tau_max, cfg.k_select)
        return sched, ue_bytes

    def _presample_round(self, sched, K: int):
        """Draw the whole round's channel + batches on the host, consuming
        the fleet and simulation RNG streams in the reference's order."""
        cfg = self.cfg
        e, steps, bs = cfg.local_epochs, cfg.steps_per_epoch, cfg.batch_size
        n_s = len(sched)
        sel = np.array([u.index for u in sched])
        xshape = self.clients[0].x.shape[1:]
        xs = np.zeros((e, K, steps, bs) + xshape, np.float32)
        ys = np.zeros((e, K, steps, bs), self.clients[0].y.dtype)
        rates = np.zeros((e, K), np.float32)
        outs = np.zeros((e, K), bool)
        for e_i in range(e):
            self.fleet.move()                  # path loss varies per epoch
            r = self.fleet.rates()
            o = self.fleet.outages()
            rates[e_i, :n_s] = r[sel]
            outs[e_i, :n_s] = o[sel]
            for j, u in enumerate(sched):
                ds = self.clients[u.index]
                idx = _epoch_indices(len(ds), cfg, self.rng)
                xs[e_i, j] = ds.x[idx]
                ys[e_i, j] = ds.y[idx]
        fr = self.fleet.rates()                # final upload: no extra move
        fo = self.fleet.outages()
        final_rate = np.zeros(K, np.float32)
        final_out = np.zeros(K, bool)
        final_rate[:n_s] = fr[sel]
        final_out[:n_s] = fo[sel]
        return xs, ys, rates, outs, final_rate, final_out

    def _user_consts(self, sched, ue_bytes: float, K: int):
        cfg = self.cfg
        n_s = len(sched)
        payload = np.full(K, cfg.model_bytes, np.float64)
        train_time = np.full(K, 1e9, np.float64)
        for j, u in enumerate(sched):
            payload[j] = cfg.model_bytes if u.mode == "FL" else ue_bytes
            train_time[j] = (
                lat.train_time_fl(self.devices[u.index], self.workloads[u.index])
                if u.mode == "FL" else
                lat.train_time_sl(self.devices[u.index], self.workloads[u.index]))
        payload *= self.compress_ratio
        rate0 = np.array([u.rate0_bps for u in sched] + [1.0] * (K - n_s))
        tau_extra0 = (cfg.b - 1) * payload * 8.0 / np.maximum(rate0, 1e-9)
        valid = np.arange(K) < n_s
        return payload, tau_extra0, train_time, valid

    def _empty_carry(self):
        k = self.cfg.k_select
        stack = tree_map(
            lambda a: torch.zeros((k,) + tuple(a.shape), dtype=a.dtype,
                                  device=self.device), self.params)
        return stack, torch.zeros(k, dtype=torch.bool, device=self.device)

    def run_round(self, t: int, carry_delayed) -> Tuple[RoundLog, object]:
        cfg = self.cfg
        sched, ue_bytes = self._schedule_round()
        log = RoundLog(round=t, selected=len(sched))
        if isinstance(carry_delayed, (list, tuple)) and not carry_delayed:
            carry_delayed = None

        if not sched:
            # nothing selected: stragglers (async) still merge on the server
            if self.scheme.carries_delayed and carry_delayed is not None:
                stack, mask = carry_delayed
                delayed = [(tree_map(lambda a: a[i], stack), 1)
                           for i in range(mask.shape[0]) if bool(mask[i])]
                self.params = self.scheme.aggregate_host(
                    [], delayed, self.params, cfg.async_alpha, cfg.async_a)
            return log, None

        K = _k_bucket(len(sched), cfg.k_select)
        xs, ys, rates, outs, final_rate, final_out = \
            self._presample_round(sched, K)
        payload, tau_extra0, train_time, valid = \
            self._user_consts(sched, ue_bytes, K)

        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        xs = put(xs)
        ys = put(ys.astype(np.int64))
        chan = {
            "rates": put(rates), "outages": put(outs),
            "payload_bits": put(np.asarray(payload * 8.0, np.float32)),
            "tau_extra0": put(np.asarray(tau_extra0, np.float32)),
            "final_rate": put(final_rate),
            "final_outage": put(final_out),
            "train_time": put(np.asarray(train_time, np.float32)),
            "valid": put(valid),
        }

        if self.scheme.carries_delayed:
            stack, mask = (carry_delayed if carry_delayed is not None
                           else self._empty_carry())
            self.params, c_stack, c_mask, stats = self._fused(
                self.params, stack, mask, xs, ys, chan)
            new_carry = (c_stack, c_mask)
        else:
            self.params, stats = self._fused(self.params, xs, ys, chan)
            new_carry = None

        # one device->host read for all five per-user outcomes
        arrived, rescued, delayed, dropped, sends = torch.stack(
            [s.to(torch.int64) for s in stats]).cpu().numpy()
        log.arrived_final = int(arrived.sum())
        log.used_snapshot = int(rescued.sum())
        log.delayed = int(delayed.sum())
        log.dropped = int(dropped.sum())
        events = sends + arrived
        log.bytes_sent = float(np.sum(payload * events))
        for j, u in enumerate(sched):
            if u.mode == "SL" and events[j] > 0:
                # one-off activation payload m_a rides the SL uplink (eq. 12)
                wl = self.workloads[u.index]
                log.bytes_sent += wl.act_bytes_per_sample * wl.samples
        return log, new_carry

    def run(self, eval_every: int = 1, verbose: bool = False) -> SimLog:
        sim = SimLog()
        delayed: object = []
        for t in range(1, self.cfg.rounds + 1):
            log, delayed = self.run_round(t, delayed)
            if t % eval_every == 0 or t == self.cfg.rounds:
                log.test_loss, log.test_acc = self.evaluate()
            sim.add(log)
            if verbose and (t % 10 == 0 or t == 1):
                print(f"[{self.cfg.scheme}/{self.cfg.distribution} b={self.cfg.b}] "
                      f"round {t}: acc={log.test_acc:.4f} loss={log.test_loss:.4f} "
                      f"rescued={log.used_snapshot} dropped={log.dropped}")
        return sim


def run_hsfl(cfg: HSFLConfig, verbose: bool = False, device=None) -> SimLog:
    """Run ``cfg.rounds`` rounds and return the per-round log."""
    return HSFLSimulation(cfg, device=device).run(verbose=verbose)
