"""OpportunisticSync: the paper's OPT scheme as a multi-pod training
feature (``repro/core/opportunistic_sync.py``), on ``torch.distributed``.

FL clients are pods running local SGD, the UAV's fluctuating air
interface is the cross-pod link (a per-pod, per-step rate trace with
outage draws), and the base station's aggregation is a masked mean over
the pods.  One rank holds one pod; the pods of a round are the ranks of a
process group (``launch.mesh.make_pod_group``, or any group):

  inner step e_t:   if e_t % (e/b) == 0:                 (scheduled probe)
                        τ = payload / rate(e_t)          (eq. 15)
                        if τ <= τ_extra and no outage:
                            snapshot <- params;  τ_extra -= τ   (eq. 16)
  round boundary:   contribution_p = arrived_p ? params_p : snapshot_p
                    ω <- Σ_p valid_p · contribution_p / Σ_p valid_p

The state lives in ``TrainState``'s snapshot/snapshot_step/tau_extra
slots.  Every decision is a ``torch.where`` on device tensors, so a round
reads nothing back to the host; the round boundary is two all-reduces
(the weights, then the weighted params in flat buckets).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.schemes import get_scheme
from repro_torch.core.transmission import schedule_period as _schedule_period
from repro_torch.device import rank_device
from repro_torch.training.train_state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_unflatten, tree_where

# elements of the flat f32 buffer a round's weighted params go through, per
# all-reduce (256 MiB); a larger leaf spans several buckets
BUCKET_ELEMS = 64 << 20


@dataclass(frozen=True)
class OppSyncConfig:
    """The reference's config without its ``axis`` field: the pod axis is
    the process group ``make_opp_sync_round`` is given."""
    inner_steps: int = 6          # e: local steps per communication round
    budget: int = 2               # b: total transmissions per round
    payload: float = 1.0          # normalized model bytes (m_i)
    rate0: float = 1.0            # budgeting rate r⁰ (eq. 14 denominator)
    outage_prob: float = 0.3
    scheme: str = "opt"           # any registered scheme: opt | discard | async ...
    async_alpha: float = 0.4
    async_a: float = 0.5

    @property
    def tau_extra0(self) -> float:
        return (self.budget - 1) * self.payload / self.rate0   # eq. (14)

    def schedule_period(self) -> int:
        return _schedule_period(self.inner_steps, self.budget)


def is_scheduled(cfg: OppSyncConfig, inner_step: torch.Tensor) -> torch.Tensor:
    """Alg. 2 line 12: e_t % (e/b) == 0, excluding the final step."""
    inner_step = torch.as_tensor(inner_step)
    if cfg.budget <= 1:
        return torch.zeros((), dtype=torch.bool, device=inner_step.device)
    per = cfg.schedule_period()
    return ((inner_step % per == 0) & (inner_step < cfg.inner_steps)
            & (inner_step > 0))


def snapshot_decision(scheduled: torch.Tensor, outage: torch.Tensor,
                      tau: torch.Tensor, tau_extra: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 lines 17–21, branch-free and shape-polymorphic (a pod's
    scalars here, (K,) vectors in the fused round): a scheduled probe
    succeeds iff the channel is up and the delay τ (eq. 15) fits the
    remaining allowance; success burns τ from the budget (eq. 16).
    Returns (ok, new_tau_extra)."""
    ok = scheduled & (~outage) & (tau <= tau_extra)
    return ok, torch.where(ok, tau_extra - tau, tau_extra)


def maybe_snapshot(cfg: OppSyncConfig, state: TrainState,
                   rate: torch.Tensor, outage: torch.Tensor) -> TrainState:
    """Opportunistic_Transmission (Alg. 2 lines 17–21), after the train
    step: the decision reads ``state.step % e``."""
    inner = state.step % cfg.inner_steps
    # eq. (15); a Python number over a tensor would be a reciprocal times
    # the number in torch, rounded twice
    tau = torch.full_like(rate, cfg.payload) / torch.clamp_min(rate, 1e-9)
    ok, tau_extra = snapshot_decision(is_scheduled(cfg, inner), outage,
                                      tau, state.tau_extra)
    return state._replace(
        snapshot=tree_where(ok, state.params, state.snapshot),
        snapshot_step=torch.where(ok, state.step, state.snapshot_step),
        tau_extra=tau_extra)


def round_contribution(cfg: OppSyncConfig, state: TrainState,
                       arrived: torch.Tensor) -> Tuple[Any, torch.Tensor]:
    """This pod's aggregation payload and weight under the chosen scheme,
    through the registry's ``pod_contribution``."""
    have_snap = state.snapshot_step >= 0
    return get_scheme(cfg.scheme).pod_contribution(
        state.params, state.snapshot, have_snap, arrived,
        alpha=cfg.async_alpha, a=cfg.async_a)


def _all_reduce_scaled(leaves, scale: torch.Tensor, group,
                       bucket_elems: int):
    """Σ over the group of ``scale · x`` for every leaf, in f32: each
    rank's products are packed into one flat buffer of at most
    ``bucket_elems`` elements, all-reduced, and unpacked, bucket by
    bucket."""
    outs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for x in leaves]
    total = sum(x.numel() for x in leaves)
    buf = torch.empty(min(bucket_elems, max(total, 1)), dtype=torch.float32,
                      device=scale.device)
    pending, fill = [], 0

    def flush():
        dist.all_reduce(buf[:fill], group=group)
        for dst, lo in pending:
            dst.copy_(buf[lo:lo + dst.numel()])
        pending.clear()

    for x, out in zip(leaves, outs):
        src, dst = x.reshape(-1), out.view(-1)
        i = 0
        while i < src.numel():
            n = min(src.numel() - i, buf.numel() - fill)
            torch.mul(src[i:i + n], scale, out=buf[fill:fill + n])
            pending.append((dst[i:i + n], fill))
            fill, i = fill + n, i + n
            if fill == buf.numel():
                flush()
                fill = 0
    if fill:
        flush()
    return outs


def round_sync(cfg: OppSyncConfig, state: TrainState, arrived: torch.Tensor,
               group=None) -> TrainState:
    """Round-boundary aggregation over the ranks of ``group`` (``None``:
    the default group), each rank one pod.  The weighted mean divides by
    the true positive sum of the weights (the async weights are
    fractional, so an all-delayed round has 0 < Σ valid < 1); with no
    valid pod the params stay as they are.  Sums in f32 and gives each
    leaf back in its own dtype (the reference's type promotion turns a
    bf16 leaf into f32 under every scheme but async).  Resets the
    snapshot slots."""
    contrib, valid = round_contribution(cfg, state, arrived)
    num = valid.reshape(1).clone()
    dist.all_reduce(num, group=group)
    num = num[0]
    summed = _all_reduce_scaled(tree_leaves(contrib), valid, group,
                                BUCKET_ELEMS)
    denom = torch.where(num > 0, num, 1.0)
    new = [torch.where(num > 0, s / denom, p).to(p.dtype)
           for s, p in zip(summed, tree_leaves(state.params))]
    new_params = tree_unflatten(state.params, iter(new))
    dev = state.step.device
    return state._replace(
        params=new_params,
        snapshot=new_params,
        snapshot_step=torch.full((), -1, dtype=torch.int32, device=dev),
        tau_extra=torch.full((), cfg.tau_extra0, dtype=torch.float32,
                             device=dev))


def channel_trace(cfg: OppSyncConfig, gen: torch.Generator, n_pods: int,
                  rounds: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Simulated per-pod link condition: log-normal rates around rate0 and
    Bernoulli outages, shape (rounds, inner_steps+1, n_pods), drawn on
    ``gen``'s device (normals first, then uniforms).  The final slot of
    each round drives the ``arrived`` draw of the round-end upload.  Every
    rank draws the whole trace from one seed and reads its own column, so
    the trace needs no collective; the draws are not ``jax.random``'s."""
    shape = (rounds, cfg.inner_steps + 1, n_pods)
    z = torch.randn(shape, generator=gen, device=gen.device)
    u = torch.rand(shape, generator=gen, device=gen.device)
    outages = u < cfg.outage_prob
    return cfg.rate0 * torch.exp(0.5 * z), outages, ~outages[:, -1, :]


def _check_state(state: TrainState, rank: int) -> torch.device:
    """The one device every leaf of ``state`` lives on, which must be the
    rank's (``device.rank_device``)."""
    devs = {t.device for t in tree_leaves(state)}
    if len(devs) != 1:
        raise ValueError(f"rank {rank}'s state spans devices "
                         f"{sorted(map(str, devs))}; a pod lives on one")
    dev = devs.pop()
    want = rank_device(dev.type, rank)
    if dev != want:
        raise ValueError(f"rank {rank}'s state lives on {dev}, but rank "
                         f"{rank} runs on {want}")
    return dev


def make_opp_sync_round(cfg: OppSyncConfig, train_step: Callable,
                        group=None) -> Callable:
    """One round of OpportunisticSync for this rank's pod.

    ``one_round(state, batches, rates, outages, arrived) -> (state,
    losses)``: ``batches`` holds this pod's ``(e, B, ...)`` leaves,
    ``rates``/``outages`` are the round's ``(e+1, n_pods)`` slices of
    ``channel_trace`` and ``arrived`` its ``(n_pods,)`` row; the rank
    reads its own column (its rank in ``group``).  Each inner step runs
    ``train_step`` then ``maybe_snapshot``; the round ends in
    ``round_sync`` over ``group`` (``None``: the default group).
    ``losses`` is ``(e,)``.  Raises if ``torch.distributed`` is not
    initialised, if this process is not in ``group``, or if the state is
    not on the rank's device."""

    def one_round(state: TrainState, batches: Dict[str, torch.Tensor],
                  rates: torch.Tensor, outages: torch.Tensor,
                  arrived: torch.Tensor):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "make_opp_sync_round needs torch.distributed initialised "
                "(one rank per pod; launch.mesh.spawn_ranks starts them)")
        pod = dist.get_rank(group)
        if pod < 0:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the pod "
                               "group")
        n_pods = dist.get_world_size(group)
        if rates.shape != (cfg.inner_steps + 1, n_pods) or \
                outages.shape != rates.shape or arrived.shape != (n_pods,):
            raise ValueError(
                f"rates/outages must be ({cfg.inner_steps + 1}, {n_pods}) "
                f"and arrived ({n_pods},); got {tuple(rates.shape)}, "
                f"{tuple(outages.shape)}, {tuple(arrived.shape)}")
        dev = _check_state(state, dist.get_rank())
        rate, outage = rates[:, pod].to(dev), outages[:, pod].to(dev)
        losses = []
        for t in range(cfg.inner_steps):
            state, metrics = train_step(
                state, {k: v[t] for k, v in batches.items()})
            state = maybe_snapshot(cfg, state, rate[t], outage[t])
            losses.append(metrics["loss"])
        state = round_sync(cfg, state, arrived[pod].to(dev), group)
        return state, torch.stack(losses)

    return one_round
