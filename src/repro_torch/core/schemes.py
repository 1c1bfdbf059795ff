"""Transmission schemes as registered objects (``repro/core/schemes.py``).

A ``Scheme`` owns the decisions every engine delegates: the probe schedule
(``static_schedule``, ``probe_schedule``), the host selection policy
(``selection_policy_host``), the final-upload deadline (``final_slack``)
and the aggregation (``aggregate`` on stacked (K, ...) tensors,
``aggregate_host`` on lists of trees, ``pod_contribution`` for one pod of
the multi-pod round).  The eight registered schemes:

  ``opt``       OPT-HSFL: probes under the eq. 14 τ_extra budget; the
                latest snapshot rescues a missed final (Alg. 2).
  ``sync``      the server waits for every scheduled final (no τ_max).
  ``async``     delayed updates merge next round at weight α(s+1)^(−a).
  ``discard``   delayed updates are dropped (the b=1 baseline).
  ``deadline``  OPT with the eq. 14 allowance charged against τ_max.
  ``opt_trimmed`` / ``opt_median`` / ``opt_clip``: OPT with a
                coordinate-wise trimmed mean, median, or a norm-clipped
                mean as the aggregate.

The device engines also ask a scheme for ``selection_policy`` (the greedy
on the device, ``selection.select_users_device``) and, in a sweep, for
``lowered_program`` (discard at b=1 runs opt's round).  A scheme carries
its sweep ``pins`` (``with_pins``); two schemes are equal when their class
and pins are.  The aggregates take one row's (K, ...) stack; the device
round applies them to each (simulation, config) row with
``torch.func.vmap``, so they must stay plain torch ops.

The robust aggregates push invalid slots to +inf before sorting and select
with ``torch.where``, never with a multiply (+inf · 0 is NaN).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core.aggregation import fedavg, fedasync_merge, fedasync_weight
from repro_torch.core.selection import schedule_users, select_users_device
from repro_torch.core.transmission import scheduled_epochs
from repro_torch.utils.tree import tree_leaves, tree_map, tree_where


# ---------------------------------------------------------------------------
# stacked-axis aggregation primitives
# ---------------------------------------------------------------------------

def kx(flags: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (K,) flag vector against a (K, ...) leaf."""
    return flags.reshape(flags.shape + (1,) * (leaf.dim() - 1))


def tree_where_k(flags, a, b):
    return tree_map(lambda x, y: torch.where(kx(flags, x), x, y), a, b)


def masked_mean(contrib, weights, fallback):
    """Σ_i w_i·x_i / Σ_i w_i over the K axis; ``fallback`` when Σ w = 0
    (the denominator is the true positive sum, never clamped to 1)."""
    num = torch.sum(weights)
    denom = torch.where(num > 0, num, 1.0)
    return tree_map(
        lambda c, p: torch.where(
            num > 0, torch.sum(c * kx(weights, c), dim=0) / denom, p),
        contrib, fallback)


def _rank_pos(weights, leaf_ndim: int):
    """The valid count m, and the rank index j broadcast against a sorted
    (K, ...) leaf (invalid slots sort to +inf past the m valid ones)."""
    m = torch.sum(weights)
    k = weights.shape[0]
    j = torch.arange(k, dtype=torch.float32, device=weights.device).reshape(
        (k,) + (1,) * (leaf_ndim - 1))
    return m, j


def _sorted_valid(c, weights):
    return torch.sort(torch.where(kx(weights, c) > 0, c, math.inf),
                      dim=0).values


def trimmed_mean(contrib, weights, fallback, trim: float = 0.25):
    """Coordinate-wise trimmed mean: drop g = ⌊trim·m⌋ from each tail of
    the m valid entries (at least one rank survives), average the rest."""
    def one(c, p):
        m, j = _rank_pos(weights, c.dim())
        s = _sorted_valid(c, weights)
        g = torch.clamp_min(torch.minimum(torch.floor(trim * m),
                                          torch.floor((m - 1.0) / 2.0)), 0.0)
        keep = (j >= g) & (j < m - g)
        cnt = torch.clamp_min(m - 2.0 * g, 1.0)
        val = torch.sum(torch.where(keep, s, 0.0), dim=0) / cnt
        return torch.where(m > 0, val, p)
    return tree_map(one, contrib, fallback)


def masked_median(contrib, weights, fallback):
    """Coordinate-wise median over the m valid slots (even m averages the
    two middle ranks)."""
    def one(c, p):
        m, j = _rank_pos(weights, c.dim())
        s = _sorted_valid(c, weights)
        lo = torch.floor((m - 1.0) / 2.0)
        hi = torch.ceil((m - 1.0) / 2.0)
        med = 0.5 * (torch.sum(torch.where(j == lo, s, 0.0), dim=0)
                     + torch.sum(torch.where(j == hi, s, 0.0), dim=0))
        return torch.where(m > 0, med, p)
    return tree_map(one, contrib, fallback)


def clipped_mean(contrib, weights, fallback):
    """Masked mean of updates whose delta from the global model is clipped
    to the masked median of the valid delta norms."""
    sq = tree_map(
        lambda c, p: torch.sum((c - p) ** 2, dim=tuple(range(1, c.dim()))),
        contrib, fallback)
    norms = torch.sqrt(sum(tree_leaves(sq)))                    # (K,)
    m, j = _rank_pos(weights, 1)
    s = torch.sort(torch.where(weights > 0, norms, math.inf)).values
    lo = torch.floor((m - 1.0) / 2.0)
    hi = torch.ceil((m - 1.0) / 2.0)
    med = 0.5 * (torch.sum(torch.where(j == lo, s, 0.0))
                 + torch.sum(torch.where(j == hi, s, 0.0)))
    scale = torch.clamp_max(med / torch.clamp_min(norms, 1e-12), 1.0)
    clipped = tree_map(lambda c, p: p + kx(scale, c) * (c - p),
                       contrib, fallback)
    return masked_mean(clipped, weights, fallback)


def _host_stack(arrived):
    """List of trees -> (stacked (n, ...) tree, all-ones weights), so that
    ``aggregate_host`` runs the stacked robust aggregates."""
    stacked = tree_map(lambda *xs: torch.stack(xs), *arrived)
    dev = tree_leaves(stacked)[0].device
    return stacked, torch.ones((len(arrived),), dtype=torch.float32,
                               device=dev)


def async_merge(params, stacked, delayed_stack, delayed_mask, arrived,
                aw: float, k_carry: int):
    """Timely finals at weight 1, prior-round stragglers at α(s+1)^(−a); a
    round with only stragglers falls back to the sequential FedAsync merge."""
    w_t = arrived.to(torch.float32)                        # (K,)
    w_d = delayed_mask.to(torch.float32) * aw              # (k_carry,)
    n_arr = torch.sum(w_t)
    total = n_arr + torch.sum(w_d)
    mixed = tree_map(
        lambda s, d, p: torch.where(
            total > 0,
            (torch.sum(s * kx(w_t, s), dim=0)
             + torch.sum(d * kx(w_d, d), dim=0))
            / torch.clamp_min(total, 1e-9), p),
        stacked, delayed_stack, params)

    seq = params
    for i in range(k_carry):
        seq = tree_map(
            lambda acc, d: torch.where(delayed_mask[i],
                                       (1.0 - aw) * acc + aw * d[i], acc),
            seq, delayed_stack)
    return tree_map(lambda a, b: torch.where(n_arr > 0, a, b), mixed, seq)


def probe_schedule_mask(e_t: int, local_epochs: int, b) -> torch.Tensor:
    """``transmission.scheduled_epochs`` membership for a budget b (a number
    or a tensor of any shape, e.g. one b per config row): e_t ≡ 0
    (mod period), e_t < e and e_t ≤ (b−1)·period, branch-free, on b's
    device."""
    bf = torch.as_tensor(b, dtype=torch.float32)
    period = torch.clamp(torch.round(local_epochs / torch.clamp_min(bf, 1.0)),
                         1.0, float(local_epochs))
    et = float(e_t)
    return ((torch.remainder(et, period) == 0) & (et < local_epochs)
            & (et <= (bf - 1.0) * period))


# ---------------------------------------------------------------------------
# the Scheme protocol
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Scheme:
    """One transmission policy.  The base class is the discard/sync family:
    no probes, no straggler carry, FedAvg over whatever arrived.

    ``pins`` carries per-scheme sweep pins (the ``("opt", {"b": 2.0})``
    entry form of ``SweepSpec``); ``name`` and the engine facts are class
    attributes, so equality and hashing are by (class, pins)."""
    pins: Tuple[Tuple[str, Any], ...] = ()

    name = "base"
    uses_probes = False        # probe/snapshot block runs
    carries_delayed = False    # the async straggler carry is live
    supports_codec = False     # snapshots exist -> codec state is meaningful

    def with_pins(self, **pins) -> "Scheme":
        """A copy with sweep pins (b/τ_max/group statics) attached."""
        merged = dict(self.pins)
        merged.update(pins)
        return replace(self, pins=tuple(sorted(merged.items())))

    def static_schedule(self, local_epochs: int, b: int,
                        override: Sequence[int] = ()) -> Tuple[int, ...]:
        """Probe epochs (Alg. 2 line 12, or the Sec. III-B override)."""
        return ()

    def probe_schedule(self, e_t, local_epochs: int, b,
                       override=None) -> torch.Tensor:
        """Is local epoch ``e_t`` a scheduled probe under budget ``b`` (a
        tensor of per-row budgets: one answer per row, on b's device)?"""
        return torch.zeros_like(torch.as_tensor(b), dtype=torch.bool)

    def selection_policy(self, rates0, flops, samples, *, b, tau_max,
                         k_select: int, model_bytes: float,
                         ue_model_bytes: float, local_epochs: int,
                         max_sl=None, **lat_kw):
        """Which users train this round (device engines): the greedy of
        Alg. 1 l. 3-5 over (G, N) rows.  Returns ``select_users_device``'s
        fixed-width slot arrays."""
        return select_users_device(
            rates0, flops, samples, b=b, tau_max=tau_max, k_select=k_select,
            model_bytes=model_bytes, ue_model_bytes=ue_model_bytes,
            local_epochs=local_epochs, max_sl=max_sl, **lat_kw)

    def selection_policy_host(self, rates0, devices, workloads,
                              model_bytes: float, ue_model_bytes: float,
                              b: int, tau_max: float, k_select: int):
        """Which users train this round: the greedy of Alg. 1 l. 3-5."""
        return schedule_users(rates0, devices, workloads, model_bytes,
                              ue_model_bytes, b, tau_max, k_select)

    def final_slack(self, tau_extra0):
        """Extra seconds charged against τ_max at the final upload."""
        return tau_extra0 * 0.0

    def aggregate(self, params, contribs, snapshots, has_snap, arrived, *,
                  delayed=None, delayed_mask=None, async_weight: float = 0.0,
                  k_carry: int = 0):
        """Merge the round (stacked (K, ...) contributions) into the global
        model.  Returns ``(new_params, rescued)``."""
        rescued = torch.zeros_like(arrived)
        new = masked_mean(contribs, arrived.to(torch.float32), params)
        return new, rescued

    def aggregate_host(self, arrived, delayed, global_params,
                       alpha: float = 0.4, a: float = 0.5):
        """List form of ``aggregate``: ``arrived`` is a list of trees,
        ``delayed`` a list of ``(update, staleness)``."""
        if not arrived:
            return global_params
        return fedavg(arrived)

    def pod_contribution(self, params, snapshot, have_snap, arrived, *,
                         alpha: float = 0.4, a: float = 0.5):
        """Per-pod twin of ``aggregate`` for the multi-pod round
        (``opportunistic_sync``): this pod's payload and its weight in the
        cross-pod mean.  ``arrived``/``have_snap`` are scalar bool tensors
        local to the pod; returns ``(contrib, valid)`` with ``valid`` a
        scalar f32 weight.  Base: a missed final contributes nothing
        (discard/sync)."""
        del snapshot, have_snap, alpha, a
        return params, arrived.to(torch.float32)

    def delayed_out(self, valid, arrived) -> torch.Tensor:
        """Which users enter next round's staleness carry."""
        return torch.zeros_like(arrived)

    def lowered_program(self, b_vals: Tuple[float, ...]) -> str:
        """The scheme whose round program runs a sweep group pinned to the
        budgets ``b_vals``: normally this one."""
        return self.name


SCHEMES: Dict[str, Scheme] = {}


def register_scheme(name: str):
    """Class decorator: instantiate and register a Scheme under ``name``."""
    def deco(cls):
        if name in SCHEMES:
            raise ValueError(f"scheme {name!r} is already registered "
                             f"({SCHEMES[name].__class__.__name__})")
        taken = next((n for n, s in SCHEMES.items() if s.__class__ is cls),
                     None)
        if taken is not None:
            raise ValueError(
                f"{cls.__name__} is already registered as {taken!r}; "
                f"subclass it to register an alias")
        cls.name = name
        SCHEMES[name] = cls()
        return cls
    return deco


def registered_schemes() -> Tuple[str, ...]:
    return tuple(sorted(SCHEMES))


def get_scheme(scheme) -> Scheme:
    """Resolve a scheme name (or pass a ``Scheme`` instance through)."""
    if isinstance(scheme, Scheme):
        return scheme
    try:
        return SCHEMES[scheme]
    except KeyError:
        raise ValueError(
            f"unknown transmission scheme {scheme!r}; registered schemes: "
            f"{', '.join(registered_schemes())}") from None


@register_scheme("discard")
class DiscardScheme(Scheme):
    """Delayed updates dropped (the b=1 / dashed baseline).  At b=1 it is
    opt with zero probes (no schedule, no eq. 14 allowance, so no
    snapshot), and a sweep runs its group on opt's round."""

    def lowered_program(self, b_vals: Tuple[float, ...]) -> str:
        return "opt" if tuple(b_vals) == (1.0,) else self.name


@register_scheme("sync")
class SyncScheme(Scheme):
    """The server waits for every scheduled final upload regardless of
    τ_max; only an upload-time outage loses one."""

    def final_slack(self, tau_extra0):
        return tau_extra0 * 0.0 - math.inf     # t + (−inf) ≤ τ_max always


@register_scheme("opt")
class OptScheme(Scheme):
    """OPT-HSFL: scheduled probes under the eq. 14 τ_extra budget; the
    latest snapshot rescues a missed final (Alg. 2)."""
    uses_probes = True
    supports_codec = True

    def static_schedule(self, local_epochs: int, b: int,
                        override: Sequence[int] = ()) -> Tuple[int, ...]:
        if b <= 1:
            return ()
        sched = (tuple(override) if override
                 else tuple(scheduled_epochs(local_epochs, b)))
        return tuple(e for e in sched if 1 <= e <= local_epochs)

    def probe_schedule(self, e_t, local_epochs: int, b,
                       override=None) -> torch.Tensor:
        if override is not None:
            # the manual schedule (Sec. III-B) does not depend on b
            return torch.full_like(torch.as_tensor(b), int(e_t) in
                                   tuple(int(o) for o in override),
                                   dtype=torch.bool)
        return probe_schedule_mask(e_t, local_epochs, b)

    def _contributions(self, contribs, snapshots, has_snap, arrived):
        rescued = (~arrived) & has_snap
        contrib = tree_where_k(arrived, contribs, snapshots)
        weights = (arrived | rescued).to(torch.float32)
        return contrib, weights, rescued

    def aggregate(self, params, contribs, snapshots, has_snap, arrived, *,
                  delayed=None, delayed_mask=None, async_weight: float = 0.0,
                  k_carry: int = 0):
        contrib, weights, rescued = self._contributions(
            contribs, snapshots, has_snap, arrived)
        return masked_mean(contrib, weights, params), rescued

    def pod_contribution(self, params, snapshot, have_snap, arrived, *,
                         alpha: float = 0.4, a: float = 0.5):
        del alpha, a
        contrib = tree_where(arrived, params, snapshot)
        return contrib, (arrived | have_snap).to(torch.float32)


@register_scheme("async")
class AsyncScheme(Scheme):
    """Delayed updates arrive next round and aggregate with the polynomial
    staleness weight α(s+1)^(−a)."""
    carries_delayed = True

    def aggregate(self, params, contribs, snapshots, has_snap, arrived, *,
                  delayed=None, delayed_mask=None, async_weight: float = 0.0,
                  k_carry: int = 0):
        new = async_merge(params, contribs, delayed, delayed_mask, arrived,
                          float(async_weight), k_carry)
        return new, torch.zeros_like(arrived)

    def aggregate_host(self, arrived, delayed, global_params,
                       alpha: float = 0.4, a: float = 0.5):
        delayed = list(delayed or [])
        if arrived:
            updates = list(arrived)
            weights = [1.0] * len(arrived)
            for upd, staleness in delayed:
                updates.append(upd)
                weights.append(fedasync_weight(staleness, alpha, a))
            return fedavg(updates, weights)
        if delayed:
            # only stragglers: the sequential FedAsync server merge
            out = global_params
            for upd, staleness in delayed:
                out = fedasync_merge(out, upd, staleness, alpha, a)
            return out
        return global_params

    def pod_contribution(self, params, snapshot, have_snap, arrived, *,
                         alpha: float = 0.4, a: float = 0.5):
        del snapshot, have_snap
        # the delayed update arrives anyway, one round stale
        w = alpha * 2.0 ** (-a)
        return params, torch.where(arrived, 1.0, w).to(torch.float32)

    def delayed_out(self, valid, arrived) -> torch.Tensor:
        return valid & ~arrived


@register_scheme("deadline")
class DeadlineScheme(OptScheme):
    """OPT with the eq. 14 probe allowance charged against the deadline:
    a final arrives only if t_train + τ_extra0 + τ_f ≤ τ_max."""

    def final_slack(self, tau_extra0):
        return tau_extra0


class _RobustOpt(OptScheme):
    """OPT probes and rescues with a robust stacked aggregate ``_robust``;
    ``aggregate_host`` stacks the arrived list and runs the same one."""

    def _robust(self, contrib, weights, fallback):
        raise NotImplementedError

    def aggregate(self, params, contribs, snapshots, has_snap, arrived, *,
                  delayed=None, delayed_mask=None, async_weight: float = 0.0,
                  k_carry: int = 0):
        contrib, weights, rescued = self._contributions(
            contribs, snapshots, has_snap, arrived)
        return self._robust(contrib, weights, params), rescued

    def aggregate_host(self, arrived, delayed, global_params,
                       alpha: float = 0.4, a: float = 0.5):
        if not arrived:
            return global_params
        stacked, w = _host_stack(arrived)
        return self._robust(stacked, w, global_params)


@register_scheme("opt_trimmed")
class OptTrimmedScheme(_RobustOpt):
    """OPT with a coordinate-wise trimmed-mean aggregate."""
    trim = 0.25

    def _robust(self, contrib, weights, fallback):
        return trimmed_mean(contrib, weights, fallback, self.trim)


@register_scheme("opt_median")
class OptMedianScheme(_RobustOpt):
    """OPT with a coordinate-wise median aggregate."""

    def _robust(self, contrib, weights, fallback):
        return masked_median(contrib, weights, fallback)


@register_scheme("opt_clip")
class OptClipScheme(_RobustOpt):
    """OPT with adaptive norm clipping before the masked mean."""

    def _robust(self, contrib, weights, fallback):
        return clipped_mean(contrib, weights, fallback)
