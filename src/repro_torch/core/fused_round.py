"""One HSFL communication round, Algorithms 1 & 2, on the device
(``build_fused_round`` of ``repro/core/fused_round.py``).

The round's channel and batches are presampled on the host
(``hsfl._presample_round``) and handed over as tensors; then, on the
device:

  - the K selected users train in lockstep: ``local_epochs`` epochs of
    ``steps_per_epoch`` SGD steps through the fused-CNN kernels
    (``kernels/fused_cnn/ops.make_stacked_epoch_fn``);
  - the OPT probe decisions run at the static probe epochs through
    ``opportunistic_sync.snapshot_decision``;
  - the scheme's final-arrival predicate and aggregate close the round;
  - with ``use_codec`` the snapshot state is the delta codec's
    ``(q (K, M, block) int8, scales (K, M, 1) f32)``: every probe epoch
    quantizes all K users' deltas from the round-start params in one
    ``quantize_blocks`` launch, and the aggregation dequantizes the state
    once, so a rescued snapshot carries the codec's quantization noise.

Every control decision is a (K,) tensor op in f32, as in the reference, so
both packages decide the same for the same presampled channel.  The
reference jits the round and donates its carries; here the global params
(and the async straggler carry) are updated in place instead.

``build_device_round`` runs the whole control plane on the device: the
fleet (``channel_lib.FleetState``) moves and fades, users are selected
(``Scheme.selection_policy``), batches are gathered from the stacked
client datasets by device indices, the round is evaluated, and nothing is
read back to the host.  It takes a whole sweep group at once: the
reference vmaps its round over configs and simulations, which a kernel
launch cannot be, so here the G = S·C (simulation, config) rows fold into
the user axis the blocked kernels already take: the group's G·K users
train with one launch per layer per step, and the eval runs the G models
at K = G.  Its draws come from the simulations' streams
(``core/streams.py``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.channel_lib import (ChannelParams, FleetState,
                                          fleet_move, fleet_outage_step,
                                          fleet_rates, fleet_resample_fading)
from repro_torch.core.opportunistic_sync import snapshot_decision
from repro_torch.core.schemes import get_scheme, kx, tree_where_k
from repro_torch.kernels.delta_codec.kernel import (BLOCK, dequantize_blocks,
                                                    quantize_blocks)
from repro_torch.kernels.delta_codec.ops import (stacked_flatten,
                                                 stacked_unflatten)
from repro_torch.kernels.fused_cnn.ops import (ForwardPolicy,
                                               make_eval_forward,
                                               make_stacked_epoch_fn,
                                               make_stacked_eval_forward,
                                               resolve_train_step)
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_clone, tree_leaves, tree_map

__all__ = ["RoundStats", "DeviceSimCarry", "DeviceRoundMetrics",
           "build_fused_round", "build_device_round"]


class RoundStats(NamedTuple):
    """Per-user round outcome, on the device until the host reads it."""
    arrived: torch.Tensor     # (K,) bool: final upload made it (Alg. 2 l. 14)
    rescued: torch.Tensor     # (K,) bool: snapshot substituted (the rescue)
    delayed: torch.Tensor     # (K,) bool: carried to next round (async)
    dropped: torch.Tensor     # (K,) bool: contributed nothing
    opp_sends: torch.Tensor   # (K,) int32: opportunistic transmissions sent


def _assign_(dst, src) -> None:
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _by_row(stacked, rows):
    """(G·K, ...) stacked leaves as (G, K, ...) views, one row per base
    params of ``rows`` (leaves (G, ...))."""
    return tree_map(lambda s, p: s.view(p.shape[0], -1, *p.shape[1:]),
                    stacked, rows)


def _codec_encode(stacked, rows, block: int = BLOCK, bits: int = 8):
    """Quantize every user's delta from its row's round-start params into
    the codec state ``(q (N, M, block), scales (N, M, 1))``: stacked
    leaves (N = G·K, ...), ``rows`` leaves (G, ...) (G = 1: the fused
    round's cohort); one launch over the ``(N·M, block)`` rows."""
    delta = tree_map(lambda s, d, p: (d - p.unsqueeze(1)).view(s.shape),
                     stacked, _by_row(stacked, rows), rows)
    flat, _ = stacked_flatten(delta, block=block)
    n, m, blk = flat.shape
    q, s = quantize_blocks(flat.reshape(n * m, blk), bits=bits)
    return q.reshape(n, m, blk), s.reshape(n, m, 1)


def _codec_decode(q, s, stacked_like, rows):
    """Dequantize the codec state back to a stacked params tree (each
    user's row params plus its delta): one launch."""
    n, m, blk = q.shape
    flat = dequantize_blocks(q.reshape(n * m, blk), s.reshape(n * m, 1))
    delta = stacked_unflatten(flat.reshape(n, m, blk), stacked_like)
    return tree_map(lambda d, r, p: (r + p.unsqueeze(1)).view(d.shape),
                    delta, _by_row(delta, rows), rows)


def _one_row(params):
    """Unstacked params as a single row (1, ...)."""
    return tree_map(lambda p: p.unsqueeze(0), params)


def _codec_zero_state(stacked, block: int = BLOCK):
    """All-zero codec state shaped for ``stacked`` (never aggregated before
    a probe succeeds: ``has_snap`` gates it)."""
    flat, _ = stacked_flatten(stacked, block=block)
    return (torch.zeros(flat.shape, dtype=torch.int8, device=flat.device),
            torch.zeros(flat.shape[:2] + (1,), dtype=torch.float32,
                        device=flat.device))


def _resolve_epoch_fns(forward: Any, lr: float) -> Tuple[Callable, Callable]:
    """``(epoch_all, eval_fwd)`` for the round builder.

    A ``ForwardPolicy`` (or ``None``: the default xla/f32 policy) gets the
    stacked-cohort epoch of ``ops.make_stacked_epoch_fn``.  A bare forward
    callable ``forward(params, x) -> logits`` (the hook that pushes non-CNN
    models through the round) gets autograd SGD, one user at a time, and is
    its own eval forward."""
    if forward is None or isinstance(forward, ForwardPolicy):
        policy = (forward or ForwardPolicy()).validate()
        return make_stacked_epoch_fn(policy, lr), make_eval_forward(policy)
    loss_grad, fwd_eval = resolve_train_step(forward)
    epoch_fn = _make_epoch_fn(loss_grad, lr)

    @torch.no_grad()
    def epoch_all(stacked, xs, ys):
        users = [epoch_fn(tree_map(lambda t: t[k], stacked), xs[k], ys[k])
                 for k in range(ys.shape[0])]
        return tree_map(lambda *ls: torch.stack(ls), *users)

    return epoch_all, fwd_eval


def _make_epoch_fn(loss_grad: Callable, lr: float) -> Callable:
    """One local epoch for one user (Alg. 1 l. 8): an SGD step per batch of
    xs (steps, B, ...), ys (steps, B); returns the new params."""

    def epoch_fn(params, xs, ys):
        for s in range(xs.shape[0]):
            _, g = loss_grad(params, xs[s], ys[s])
            params = tree_map(lambda w, gg: w - lr * gg, params, g)
        return params

    return epoch_fn


def build_fused_round(*, scheme: Any, local_epochs: int, steps_per_epoch: int,
                      lr: float, tau_max: float, probe_epochs: Tuple[int, ...],
                      async_weight: float = 0.0, use_codec: bool = False,
                      k_carry: int = 0, forward: Any = None,
                      codec_block: int = BLOCK, codec_bits: int = 8
                      ) -> Callable:
    """One HSFL round for a fixed (scheme, e, steps, schedule).

    Returns ``round_fn(params, xs, ys, chan) -> (params, stats)``, or for
    schemes that carry stragglers (async)
    ``round_fn(params, delayed_stack, delayed_mask, xs, ys, chan) ->
    (params, delayed_stack, delayed_mask, stats)`` with ``delayed_stack``
    leaves (k_carry, ...).  xs is (e, K, steps, B, H, W, C), ys
    (e, K, steps, B); ``chan`` holds rates/outages (e, K),
    payload_bits/tau_extra0/final_rate/train_time (K,) f32 and
    final_outage/valid (K,) bool.

    ``params`` (and the straggler carry) are updated in place and returned:
    where the reference donates those buffers to its jitted round, the port
    writes the round's result into them.  xs and ys must carry
    ``local_epochs`` epochs of ``steps_per_epoch`` steps.
    ``codec_block``/``codec_bits`` are the delta codec's group width and
    bit depth (``HSFLConfig.codec_block``/``codec_bits``).  ``forward`` is
    a ``ForwardPolicy``, ``None`` (the default policy) or a bare forward
    callable (see ``_resolve_epoch_fns``).
    """
    epoch_all, _ = _resolve_epoch_fns(forward, lr)
    scheme = get_scheme(scheme)

    if scheme.carries_delayed and k_carry < 1:
        raise ValueError(
            f"{scheme.name} build_fused_round needs k_carry >= 1 (the fixed "
            f"width of the straggler carry), got k_carry={k_carry}")

    def _train_and_probe(params, xs, ys, chan):
        k = chan["valid"].shape[0]
        if tuple(xs.shape[:3]) != (local_epochs, k, steps_per_epoch) or \
                tuple(ys.shape[:3]) != (local_epochs, k, steps_per_epoch):
            raise ValueError(
                f"round inputs xs {tuple(xs.shape)} / ys {tuple(ys.shape)} "
                f"are not (e={local_epochs}, K={k}, "
                f"steps={steps_per_epoch}, B, ...)")
        stacked = tree_map(
            lambda a: a.unsqueeze(0).repeat((k,) + (1,) * a.dim()), params)
        tau_extra = chan["tau_extra0"]
        has_snap = torch.zeros_like(chan["valid"])
        nsent = torch.zeros(k, dtype=torch.int32, device=has_snap.device)
        # snapshots start as the round-start broadcast (weight 0 until a
        # probe succeeds)
        if use_codec:
            snap = _codec_zero_state(stacked, codec_block)
        else:
            snap = tree_clone(stacked) if scheme.uses_probes or probe_epochs \
                else None
        for e_t in range(1, local_epochs + 1):
            stacked = epoch_all(stacked, xs[e_t - 1], ys[e_t - 1])
            if e_t in probe_epochs:
                rate = chan["rates"][e_t - 1]
                outage = chan["outages"][e_t - 1]
                tau = chan["payload_bits"] / torch.clamp_min(rate, 1e-9)
                ok, tau_extra = snapshot_decision(chan["valid"], outage,
                                                  tau, tau_extra)
                if use_codec:
                    q_new, s_new = _codec_encode(stacked, _one_row(params),
                                                 codec_block, codec_bits)
                    snap = (torch.where(kx(ok, q_new), q_new, snap[0]),
                            torch.where(kx(ok, s_new), s_new, snap[1]))
                else:
                    snap = tree_where_k(ok, stacked, snap)
                has_snap = has_snap | ok
                nsent = nsent + ok.to(torch.int32)
        return stacked, snap, has_snap, nsent

    def _final_arrival(chan):
        tau_f = chan["payload_bits"] / torch.clamp_min(chan["final_rate"], 1e-9)
        fits = chan["train_time"] + scheme.final_slack(chan["tau_extra0"]) \
            + tau_f <= tau_max
        return chan["valid"] & (~chan["final_outage"]) & fits

    if not scheme.carries_delayed:

        @torch.no_grad()
        def round_fn(params, xs, ys, chan):
            stacked, snap, has_snap, nsent = _train_and_probe(
                params, xs, ys, chan)
            arrived = _final_arrival(chan)
            if use_codec and scheme.uses_probes:
                snap = _codec_decode(snap[0], snap[1], stacked,
                                     _one_row(params))
            new_params, rescued = scheme.aggregate(params, stacked, snap,
                                                   has_snap, arrived)
            delayed = scheme.delayed_out(chan["valid"], arrived)
            dropped = chan["valid"] & ~arrived & ~rescued & ~delayed
            _assign_(params, new_params)
            return params, RoundStats(arrived, rescued, delayed, dropped,
                                      nsent)

        return round_fn

    aw = float(async_weight)

    @torch.no_grad()
    def round_fn(params, delayed_stack, delayed_mask, xs, ys, chan):
        k = chan["valid"].shape[0]
        if k > k_carry:
            raise ValueError(
                f"{scheme.name} round got K={k} stacked users but the "
                f"straggler carry is only k_carry={k_carry} wide")
        stacked, _, _, nsent = _train_and_probe(params, xs, ys, chan)
        arrived = _final_arrival(chan)
        delayed_new = scheme.delayed_out(chan["valid"], arrived)
        new_params, rescued = scheme.aggregate(
            params, stacked, None, None, arrived, delayed=delayed_stack,
            delayed_mask=delayed_mask, async_weight=aw, k_carry=k_carry)
        _assign_(params, new_params)
        # next round's straggler carry, written in place, zero-padded to
        # the fixed k_carry width
        for d, s in zip(tree_leaves(delayed_stack), tree_leaves(stacked)):
            d[:k].copy_(s)
            d[k:].zero_()
        delayed_mask[:k].copy_(delayed_new)
        delayed_mask[k:] = False
        dropped = chan["valid"] & ~arrived & ~rescued & ~delayed_new
        return (params, delayed_stack, delayed_mask,
                RoundStats(arrived, rescued, delayed_new, dropped, nsent))

    return round_fn


# ---------------------------------------------------------------------------
# the on-device round over a sweep group of G = S·C rows
# ---------------------------------------------------------------------------

class DeviceSimCarry(NamedTuple):
    """What a sweep group carries from round to round.  Row g = s·C + c is
    simulation s under config c.  The fleet is kept once per simulation:
    no fleet transition reads a config (the reference's per-config copies
    are equal), only the rates see a config's bandwidth.  The straggler
    stack is the async carry; other schemes carry it untouched."""
    params: Any                  # (G, ...) global params
    fleet: FleetState            # (S, N, ...)
    delayed: Any                 # (G, K, ...) straggler params
    delayed_mask: torch.Tensor   # (G, K) bool


class DeviceRoundMetrics(NamedTuple):
    """Per-round values of each row (G,), on the device until the sweep
    reads them."""
    selected: torch.Tensor       # int32: users scheduled this round
    arrived: torch.Tensor        # int32: finals that made it (Alg. 2 l. 14)
    rescued: torch.Tensor        # int32: snapshot substitutions
    delayed: torch.Tensor        # int32: carried to next round (async)
    dropped: torch.Tensor        # int32: contributed nothing
    bytes_sent: torch.Tensor     # f32: uplink bytes this round
    test_loss: torch.Tensor      # f32
    test_acc: torch.Tensor       # f32


def _rep(t: torch.Tensor, n: int) -> torch.Tensor:
    """Each row of t repeated n times on a new copy: (A, ...) -> (A·n, ...)
    (``repeat_interleave`` with a count would read a size back)."""
    return t.unsqueeze(1).expand(t.shape[0], n, *t.shape[1:]).contiguous() \
        .view(t.shape[0] * n, *t.shape[1:])


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order (zero-padded to a
    power of two, then halved), whatever the leading shape: a row's metric
    does not depend on how many rows share the call, as a library
    reduction's order may."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _resolve_device_round_fns(forward: Any, lr: float
                              ) -> Tuple[Callable, Callable]:
    """``(epoch_all, eval_k)`` for the device round: the folded cohort's
    epoch and the eval of its G models (``eval_k(params (G, ...), images
    (G, B, ...)) -> logits (G, B, classes) f32``)."""
    if forward is None or isinstance(forward, ForwardPolicy):
        policy = (forward or ForwardPolicy()).validate()
        return (make_stacked_epoch_fn(policy, lr),
                make_stacked_eval_forward(policy))
    if not callable(forward):
        raise TypeError(
            f"build_device_round: forward must be a ForwardPolicy, None or "
            f"a callable forward(params, x) -> logits that the round can "
            f"train by autograd and evaluate; got {type(forward).__name__}")
    epoch_all, fwd_eval = _resolve_epoch_fns(forward, lr)

    @torch.no_grad()
    def eval_each(params, images):
        return torch.stack([fwd_eval(tree_map(lambda t: t[g], params),
                                     images[g]).float()
                            for g in range(images.shape[0])])

    return epoch_all, eval_each


def build_device_round(*, scheme: Any, local_epochs: int,
                       steps_per_epoch: int, batch_size: int, lr: float,
                       k_select: int, channel: ChannelParams,
                       model_bytes: float, ue_model_fraction: float,
                       compress_ratio: float = 1.0,
                       use_codec: bool = False,
                       speed_mps: float = 15.0, epoch_seconds: float = 1.0,
                       schedule_override: Tuple[int, ...] = (),
                       async_alpha: float = 0.4, async_a: float = 0.5,
                       max_sl: int | None = None,
                       act_bytes_per_sample: float = 3136.0,
                       codec_block: int = BLOCK, codec_bits: int = 8,
                       forward: Any = None) -> Callable:
    """One HSFL round of a sweep group with the whole control plane on the
    device (``build_device_round`` of the reference).

    Returns ``round_fn(carry, round_t, stream, sim, cfg) -> (carry,
    metrics)``:

    - ``carry``: ``DeviceSimCarry`` over the group's G = S·C rows;
    - ``round_t``: the round, from 1 (the streams key their batches by it);
    - ``stream``: a ``streams.GroupStream`` of the S simulations;
    - ``sim``: per-simulation tensors on the device: ``client_x``
      (S, N, M, H, W, C), ``client_y`` (S, N, M) int64, ``client_len``,
      ``flops``, ``samples`` (S, N), ``test_x`` (S, T, H, W, C), ``test_y``
      (S, T) int64;
    - ``cfg``: ``b``, ``tau_max``, ``bandwidth_ratio``, (C,) f32.

    Per round: fresh fading, the scheme's selection (one greedy per row),
    then ``local_epochs`` epochs in lockstep.  Every epoch the fleets move,
    the rates and outages of the selected users are read, a batch of
    ``steps_per_epoch`` x ``batch_size`` samples is gathered for each of
    the G·K users, and the whole folded cohort takes its SGD steps through
    ``ops.make_stacked_epoch_fn`` (one launch per layer per step, whatever
    G is).  The probes run masked every epoch, since the schedule depends
    on each row's b (``Scheme.probe_schedule``); with ``use_codec`` every
    epoch quantizes all G·K users' deltas in one launch and the round
    dequantizes once.  The final upload reads one more outage step, the
    scheme aggregates each row (``torch.func.vmap`` over its (K, ...)
    ``aggregate``), and the G new models are evaluated at K = G
    (``ops.make_stacked_eval_forward``).  ``compress_ratio`` scales every
    payload (selection energy, the eq. 14/15 budgets, the bytes).

    ``forward`` is the group's ``ForwardPolicy`` (``None``: the default),
    or a bare forward callable ``forward(params, x) -> logits``, as
    ``build_fused_round`` takes one (``_resolve_epoch_fns``): its users
    train by autograd one at a time and its G models are evaluated one at
    a time.  Anything else raises a ``TypeError``.
    The round reads nothing back to the host: no ``.item()``, no boolean
    indexing, no tensor made from host data.

    Host spans (``utils.trace``; the loop is host-paced): ``round``, and
    inside it ``round.schedule`` (fading, selection), one ``round.epoch``
    an epoch (the fleet's move, the outage, the gather) holding
    ``round.train`` and ``round.probe``, then ``round.final`` (the final
    upload), ``round.aggregate`` and ``round.eval`` (the eval and the
    round's metrics).
    """
    epoch_all, eval_k = _resolve_device_round_fns(forward, lr)
    scheme = get_scheme(scheme)
    aw = float(async_alpha) * 2.0 ** (-float(async_a))
    eff_model_bytes = model_bytes * compress_ratio
    eff_ue_bytes = eff_model_bytes * ue_model_fraction
    use_codec = bool(use_codec) and scheme.supports_codec
    override = tuple(schedule_override) or None
    K, p = k_select, channel
    nb = steps_per_epoch * batch_size

    def aggregate(params, stacked, snap, has_snap, arrived, delayed,
                  delayed_mask):
        return scheme.aggregate(params, stacked, snap, has_snap, arrived,
                                delayed=delayed, delayed_mask=delayed_mask,
                                async_weight=aw, k_carry=K)

    aggregate_rows = torch.func.vmap(aggregate)

    @torch.no_grad()
    def round_fn(carry: DeviceSimCarry, round_t: int, stream, sim, cfg):
        with trace.span("round"):
            return _round(carry, round_t, stream, sim, cfg)

    def _round(carry: DeviceSimCarry, round_t: int, stream, sim, cfg):
        params, fleet = carry.params, carry.fleet
        S, N = fleet.k_db.shape
        C = cfg["b"].shape[0]
        G = S * C
        dev = fleet.k_db.device
        b, tau_max = cfg["b"].repeat(S), cfg["tau_max"].repeat(S)
        bw = cfg["bandwidth_ratio"].view(1, C, 1)
        row_sim = _rep(torch.arange(S, device=dev), C)          # (G,)

        def rates(fl):                                           # (G, N)
            return fleet_rates(fl._replace(pos=fl.pos[:, None],
                                           k_db=fl.k_db[:, None]),
                               p, bw).reshape(G, N)

        def pick(t):                                             # (G, K)
            return torch.gather(t, 1, sel)

        # -- schedule (Alg. 1 l. 3-5): fresh fading, greedy selection ------
        with trace.span("round.schedule"):
            fleet = fleet_resample_fading(
                fleet, stream.fleet_uniform(N, *p.k_db_range))
            rates0 = rates(fleet)
            sel, mode_sl, valid, n_taken, tt_fl, tt_sl = \
                scheme.selection_policy(
                    rates0, _rep(sim["flops"], C), _rep(sim["samples"], C),
                    b=b, tau_max=tau_max, k_select=K,
                    model_bytes=eff_model_bytes, ue_model_bytes=eff_ue_bytes,
                    local_epochs=local_epochs, max_sl=max_sl,
                    act_bytes_per_sample=act_bytes_per_sample)
            train_time = torch.where(valid, torch.where(
                mode_sl, pick(tt_sl), pick(tt_fl)), 1e9)
            payload_bits = torch.where(mode_sl, eff_ue_bytes,
                                       eff_model_bytes) * 8.0  # eq. (15) m_i
            tau_extra0 = torch.clamp_min(b - 1.0, 0.0)[:, None] \
                * payload_bits / torch.clamp_min(pick(rates0), 1e-9)  # (14)

        # -- local training: the G·K users of the group in lockstep --------
        stacked = tree_map(lambda a: _rep(a, K), params)        # (G·K, ...)
        clen = torch.clamp_min(pick(_rep(sim["client_len"], C)), 1)
        xshape = sim["client_x"].shape[3:]
        M = sim["client_x"].shape[2]
        client_x = sim["client_x"].reshape(-1, *xshape)
        client_y = sim["client_y"].reshape(-1)
        base = (row_sim[:, None] * N + sel) * M                 # (G, K)
        if use_codec:
            snap = _codec_zero_state(stacked, codec_block)
        elif scheme.uses_probes:
            snap = tree_map(lambda a: _rep(a, K), params)
        else:
            snap = stacked
        has_snap = torch.zeros((G, K), dtype=torch.bool, device=dev)
        nsent = torch.zeros((G, K), dtype=torch.int32, device=dev)
        tau_extra = tau_extra0
        for e_t in range(1, local_epochs + 1):
            with trace.span("round.epoch"):
                fleet = fleet_move(fleet, p, speed_mps, epoch_seconds,
                                   stream.fleet_normal((N, 3)))
                rate_e = pick(rates(fleet))
                fleet, bad = fleet_outage_step(fleet, p,
                                               stream.fleet_uniform(N))
                out_e = pick(_rep(bad, C))
                idx = (base[..., None] + stream.batch_indices(
                    round_t, e_t, clen, nb)).reshape(-1)
                xs = client_x.index_select(0, idx).reshape(
                    G * K, steps_per_epoch, batch_size, *xshape)
                ys = client_y.index_select(0, idx).reshape(
                    G * K, steps_per_epoch, batch_size)
                with trace.span("round.train"):
                    stacked = epoch_all(stacked, xs, ys)
                if scheme.uses_probes:
                    with trace.span("round.probe"):
                        sched = scheme.probe_schedule(e_t, local_epochs, b,
                                                      override=override)
                        tau = payload_bits / torch.clamp_min(rate_e, 1e-9)
                        ok, tau_extra = snapshot_decision(
                            valid & sched[:, None], out_e, tau, tau_extra)
                        okf = ok.reshape(G * K)
                        if use_codec:
                            q_new, s_new = _codec_encode(
                                stacked, params, codec_block, codec_bits)
                            snap = (torch.where(kx(okf, q_new), q_new,
                                                snap[0]),
                                    torch.where(kx(okf, s_new), s_new,
                                                snap[1]))
                        else:
                            snap = tree_where_k(okf, stacked, snap)
                        has_snap = has_snap | ok
                        nsent = nsent + ok.to(torch.int32)

        # -- final upload (Alg. 2 l. 14): no extra move ---------------------
        with trace.span("round.final"):
            rate_f = pick(rates(fleet))
            fleet, bad_f = fleet_outage_step(fleet, p,
                                             stream.fleet_uniform(N))
            tau_f = payload_bits / torch.clamp_min(rate_f, 1e-9)
            fits = train_time + scheme.final_slack(tau_extra0) + tau_f \
                <= tau_max[:, None]
            arrived = valid & ~pick(_rep(bad_f, C)) & fits

        # -- aggregation: the scheme's (K, ...) aggregate on every row ------
        with trace.span("round.aggregate"):
            if use_codec:
                snap = _codec_decode(snap[0], snap[1], stacked, params)
            new_params, rescued = aggregate_rows(
                params, _by_row(stacked, params), _by_row(snap, params),
                has_snap, arrived, carry.delayed, carry.delayed_mask)
            delayed_new = scheme.delayed_out(valid, arrived)
            dropped = valid & ~arrived & ~rescued & ~delayed_new
            if scheme.carries_delayed:
                new_carry = DeviceSimCarry(new_params, fleet,
                                           _by_row(stacked, params),
                                           delayed_new)
            else:
                new_carry = DeviceSimCarry(new_params, fleet, carry.delayed,
                                           carry.delayed_mask)

        # -- byte accounting + eval -----------------------------------------
        # (every sum over a row runs in _row_sum's fixed order)
        with trace.span("round.eval"):
            events = nsent + arrived.to(torch.int32)
            bytes_sent = _row_sum(torch.where(
                valid, payload_bits / 8.0 * events, 0.0))
            act = act_bytes_per_sample * pick(_rep(sim["samples"], C))
            bytes_sent = bytes_sent + _row_sum(
                torch.where(valid & mode_sl & (events > 0), act, 0.0))
            test_x = sim["test_x"] if C == 1 else _rep(sim["test_x"], C)
            test_y = sim["test_y"] if C == 1 else _rep(sim["test_y"], C)
            logits = eval_k(new_params, test_x)                 # (G, T, V)
            top = torch.amax(logits, dim=-1, keepdim=True)
            logz = torch.log(_row_sum(torch.exp(logits - top))) \
                + top[..., 0]
            gold = torch.gather(logits, -1, test_y[..., None])[..., 0]
            n_test = test_y.shape[-1]
            hits = (torch.argmax(logits, -1) == test_y).to(torch.float32)
            count = lambda m: torch.sum(  # noqa: E731
                m.to(torch.int32), dim=1, dtype=torch.int32)
            metrics = DeviceRoundMetrics(
                selected=n_taken, arrived=count(arrived),
                rescued=count(rescued), delayed=count(delayed_new),
                dropped=count(dropped), bytes_sent=bytes_sent.float(),
                test_loss=_row_sum(logz - gold) / n_test,
                test_acc=_row_sum(hits) / n_test)
        return new_carry, metrics

    return round_fn
