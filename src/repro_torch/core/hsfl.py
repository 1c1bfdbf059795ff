"""The HSFL + OPT simulation, Algorithms 1 & 2 end to end
(``repro/core/hsfl.py``).

The paper's setting (Section IV): 30 UAVs, 10 selected per round, e=6 local
epochs of 4 steps, batch 10, lr 0.01, the 5-layer CNN, a Rician channel
with per-round K resampling, per-epoch path-loss variation and a 30%
complete-interruption probability.  Two round engines share the control
plane, as in the reference:

- fused (default, ``build_fused_round``): the host selects users through
  the scheme registry and presamples the round's channel and batches from
  the numpy streams, in exactly the reference's order; the device trains
  the K users in lockstep through the fused-CNN kernels, makes the OPT
  probe decisions and aggregates, under any ``ForwardPolicy`` (kernel,
  precision, batch_users); eval runs the f32 forward kernels.
- host (``use_fused_round=False``): the reference loop over one
  ``OppTransmitter`` per user, autograd SGD over ``cnn.forward`` for the
  stacked cohort, list-form aggregation; the serving path
  (``serving/fl_server``) wraps it.

With ``use_delta_codec`` the snapshots go through the delta codec's
kernels (``kernels/delta_codec``) in both engines, and the payload's
compression ratio is derived from the model's int8/int4 byte count.

``HSFLSimulation(cfg, device=None)`` runs on the CUDA card and raises when
there is none; ``device="cpu"`` runs the kernels' plain twins.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import latency as lat
from repro_torch.core.channel import ChannelParams, UAVFleet
from repro_torch.core.fused_round import build_fused_round
from repro_torch.core.metrics import RoundLog, SimLog
from repro_torch.core.schemes import get_scheme
from repro_torch.core.transmission import OppTransmitter
from repro_torch.data.partition import partition
from repro_torch.data.synthetic import Dataset, make_digits
from repro_torch.device import resolve_device
from repro_torch.kernels.delta_codec.ops import (codec_ratio, decode_delta,
                                                 encode_delta)
from repro_torch.kernels.fused_cnn.ops import ForwardPolicy, make_eval_forward
from repro_torch.models import cnn as cnn_mod
from repro_torch.training.loss import accuracy, cross_entropy
from repro_torch.utils.tree import tree_leaves, tree_map


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
    # int8/int4 delta-codec snapshots (kernels/delta_codec): compress_ratio
    # is then derived from the model's byte count; codec_block is the
    # quantization group width, codec_bits the bit depth (8 or 4)
    use_delta_codec: bool = False
    codec_block: int = 512
    codec_bits: int = 8
    use_fused_round: bool = True   # False -> host OppTransmitter reference
    # CNN hot-path policy of the fused engine (kernels/fused_cnn.
    # ForwardPolicy): kernel xla | pallas (both the port's kernels) |
    # im2col (autograd baseline); precision f32 | bf16 (mixed precision);
    # batch_users False -> the single-user kernels, once per user slot.
    # The host engine always runs the autograd step; eval is f32 always
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
    """The snapshot compression ratio: with ``use_delta_codec`` the codec's
    exact byte ratio for this CNN (its parameter count from the shapes, no
    tensor made), else ``cfg.compress_ratio``."""
    if not cfg.use_delta_codec:
        return cfg.compress_ratio
    n = sum(math.prod(shape) for layer in cnn_mod.param_shapes().values()
            for shape in layer.values())
    return codec_ratio(n, cfg.codec_block, cfg.codec_bits)


def _heterogeneous_devices(n: int, rng: np.random.Generator,
                           flops_range=(1.5e8, 6e8)) -> List[lat.DeviceProfile]:
    return [lat.DeviceProfile(flops_per_sec=float(rng.uniform(*flops_range)))
            for _ in range(n)]


def build_sim_arrays(cfg: HSFLConfig, pad_len: int | None = None) -> Dict:
    """Per-simulation constant arrays of the on-device engine (numpy),
    drawn with the host simulation's seeding: data and partition from
    ``cfg.seed``, device FLOPS from ``default_rng(cfg.seed)`` in
    ``HSFLSimulation``'s draw order.  Client datasets are zero-padded to
    ``pad_len`` (default: the longest client), so that simulations stack."""
    rng = np.random.default_rng(cfg.seed)
    full = make_digits(cfg.n_train + cfg.n_test, seed=cfg.seed)
    test = Dataset(full.x[cfg.n_train:], full.y[cfg.n_train:])
    train = Dataset(full.x[:cfg.n_train], full.y[:cfg.n_train])
    clients = partition(train, cfg.n_uavs, cfg.distribution, cfg.seed)
    devices = _heterogeneous_devices(cfg.n_uavs, rng, cfg.flops_range)

    m = pad_len or max(len(c) for c in clients)
    xshape = clients[0].x.shape[1:]
    client_x = np.zeros((cfg.n_uavs, m) + xshape, np.float32)
    client_y = np.zeros((cfg.n_uavs, m), clients[0].y.dtype)
    client_len = np.zeros((cfg.n_uavs,), np.int32)
    for i, c in enumerate(clients):
        k = min(len(c), m)
        client_x[i, :k] = c.x[:k]
        client_y[i, :k] = c.y[:k]
        client_len[i] = k
    return {
        "client_x": client_x,
        "client_y": client_y,
        "client_len": client_len,
        "flops": np.array([d.flops_per_sec for d in devices], np.float32),
        "samples": np.array([len(c) for c in clients], np.float32),
        "test_x": test.x.astype(np.float32),
        "test_y": test.y,
    }


def _epoch_indices(n: int, cfg: HSFLConfig, rng: np.random.Generator) -> np.ndarray:
    """Fixed-shape (steps, bs) batch indices for one local epoch."""
    need = cfg.steps_per_epoch * cfg.batch_size
    idx = rng.permutation(n)
    while len(idx) < need:
        idx = np.concatenate([idx, rng.permutation(n)])
    return idx[:need].reshape(cfg.steps_per_epoch, cfg.batch_size)


def _sample_epoch(ds: Dataset, cfg: HSFLConfig, rng: np.random.Generator):
    """Fixed-shape epoch batches (steps, bs, ...), as numpy."""
    idx = _epoch_indices(len(ds), cfg, rng)
    return ds.x[idx], ds.y[idx]


def _cohort_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Σ_k of user k's mean cross entropy over (K, B) logits: its gradient
    with respect to user k's params is that user's own (the reference
    vmaps one user's ``jax.grad``)."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(torch.mean(torch.logsumexp(logits, -1) - gold, dim=-1))


def _k_bucket(n_sched: int, k_select: int) -> int:
    """Pad K to a small even bucket.  Padded slots hold zero images with
    label 0, are ``valid=False`` and still train, as in the reference."""
    return min(k_select, 2 * ((n_sched + 1) // 2))


class HSFLSimulation:
    """Control plane on the host around the fused or the host round."""

    def __init__(self, cfg: HSFLConfig, device=None):
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
        self._eval_fwd = cnn_mod.forward
        if cfg.use_fused_round:
            policy = ForwardPolicy(kernel=cfg.kernel,
                                   precision=cfg.precision,
                                   block_k=cfg.block_k,
                                   batch_users=cfg.batch_users).validate()
            # eval computes in f32 whatever the policy, as the reference's
            # (cnn.forward) does: the f32 forward kernels at K=1
            self._eval_fwd = make_eval_forward(ForwardPolicy())
            self._fused = build_fused_round(
                scheme=self.scheme, local_epochs=cfg.local_epochs,
                steps_per_epoch=cfg.steps_per_epoch, lr=cfg.lr,
                tau_max=cfg.tau_max, probe_epochs=self._probe_epochs,
                async_weight=cfg.async_alpha * 2.0 ** (-cfg.async_a),
                use_codec=cfg.use_delta_codec, k_carry=cfg.k_select,
                forward=policy, codec_block=cfg.codec_block,
                codec_bits=cfg.codec_bits)

    @torch.no_grad()
    def evaluate(self) -> Tuple[float, float]:
        logits = self._eval_fwd(self.params, self._test_x)
        return (float(cross_entropy(logits, self._test_y)),
                float(accuracy(logits, self._test_y)))

    def _epoch_all(self, stacked, xs: torch.Tensor, ys: torch.Tensor):
        """One local epoch for the whole cohort (host engine): for each of
        the ``steps`` batches of xs (K, steps, B, ...), one SGD step of every
        user by autograd over ``cnn.forward``."""
        lr = self.cfg.lr
        for s in range(xs.shape[1]):
            p = tree_map(lambda t: t.detach().requires_grad_(True), stacked)
            loss = _cohort_loss(cnn_mod.forward(p, xs[:, s]), ys[:, s])
            grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
            with torch.no_grad():
                stacked = tree_map(lambda w: w - lr * next(grads), p)
        return stacked

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
            train_time[j] = self.train_time(u)
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
        if self.cfg.use_fused_round:
            return self._run_round_fused(t, carry_delayed)
        return self._run_round_host(t, carry_delayed)

    def _run_round_fused(self, t: int, carry_delayed):
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

        put = self._to_device
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

    # -- host reference engine ----------------------------------------------
    def _run_round_host(self, t: int, carry_delayed
                        ) -> Tuple[RoundLog, List[tuple]]:
        cfg = self.cfg
        carry_delayed = list(carry_delayed or [])
        sched, ue_bytes = self._schedule_round()

        log = RoundLog(round=t, selected=len(sched))
        if not sched:
            self.params = self.scheme.aggregate_host(
                [], carry_delayed, self.params, cfg.async_alpha, cfg.async_a)
            return log, []
        txs: Dict[int, OppTransmitter] = {}
        for u in sched:
            payload = cfg.model_bytes if u.mode == "FL" else ue_bytes
            txs[u.index] = OppTransmitter(
                payload, cfg.local_epochs, cfg.b, u.rate0_bps,
                compress_ratio=self.compress_ratio,
                schedule_override=cfg.schedule_override)

        # stacked per-user params (K, ...): everyone starts from the global
        K = _k_bucket(len(sched), cfg.k_select)
        stacked = self.broadcast(K)

        def user_tree(i: int):
            return tree_map(lambda a: a[i], stacked)

        # local training: epochs advance in lockstep; channel drifts per epoch
        for e_t in range(1, cfg.local_epochs + 1):
            self.fleet.move()                  # path loss varies per epoch
            rates = self.fleet.rates()
            outages = self.fleet.outages()
            stacked = self._epoch_all(stacked, *self.epoch_batches(sched, K))
            if self._probe_epochs:
                for i, u in enumerate(sched):
                    if e_t in txs[u.index].schedule:
                        txs[u.index].maybe_transmit(
                            e_t, float(rates[u.index]),
                            bool(outages[u.index]),
                            lambda i=i: self.snapshot_of(user_tree(i)))

        # final uploads
        arrived: List[object] = []
        new_delayed: List[tuple] = []
        rates = self.fleet.rates()
        outages = self.fleet.outages()
        for i, u in enumerate(sched):
            tx = txs[u.index]
            # the scheme's deadline: extra seconds charged against τ_max
            slack = float(self.scheme.final_slack(tx.tau_extra0))
            ok = tx.final_upload(float(rates[u.index]), bool(outages[u.index]),
                                 self.train_time(u) + slack, cfg.tau_max)
            if ok:
                arrived.append(user_tree(i))
                log.arrived_final += 1
            elif self.scheme.uses_probes and tx.snapshot is not None:
                arrived.append(tx.snapshot)     # the paper's rescue
                log.used_snapshot += 1
            elif self.scheme.carries_delayed:
                new_delayed.append((user_tree(i), 1))      # max delay 1
                log.delayed += 1
            else:
                log.dropped += 1
            log.bytes_sent += tx.bytes_sent
            if u.mode == "SL" and tx.events:
                # one-off activation payload m_a rides the SL uplink (eq. 12)
                log.bytes_sent += self.workloads[u.index].act_bytes_per_sample \
                    * self.workloads[u.index].samples

        self.params = self.scheme.aggregate_host(
            arrived, carry_delayed, self.params,
            cfg.async_alpha, cfg.async_a)
        return log, new_delayed

    # -- pieces of the host round the serving path shares ----------------------
    def broadcast(self, k: int):
        """The global params repeated over a leading cohort axis of k."""
        return tree_map(
            lambda a: a.unsqueeze(0).expand((k,) + tuple(a.shape)),
            self.params)

    def epoch_batches(self, sched, k: int):
        """One epoch's batches of the scheduled users from the simulation
        stream, on the device: xs (k, steps, B, ...), ys (k, steps, B).
        Unused slots repeat user 0's batches (they train and are ignored)."""
        eb = [_sample_epoch(self.clients[u.index], self.cfg, self.rng)
              for u in sched]
        while len(eb) < k:
            eb.append(eb[0])
        return (self._to_device(np.stack([b[0] for b in eb])),
                self._to_device(np.stack([b[1] for b in eb]).astype(np.int64)))

    def snapshot_of(self, tree):
        """The snapshot the server holds of one user's params: the tree
        itself, or with the codec its quantize-dequantize round trip (the
        server only ever holds the int8 delta payload)."""
        if not self.cfg.use_delta_codec:
            return tree
        payload = encode_delta(tree, self.params, block=self.cfg.codec_block,
                               bits=self.cfg.codec_bits)
        return decode_delta(payload, self.params)

    def train_time(self, u) -> float:
        dev, wl = self.devices[u.index], self.workloads[u.index]
        return (lat.train_time_fl(dev, wl) if u.mode == "FL"
                else lat.train_time_sl(dev, wl))

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
