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
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.opportunistic_sync import snapshot_decision
from repro_torch.core.schemes import get_scheme, kx, tree_where_k
from repro_torch.kernels.delta_codec.kernel import (BLOCK, dequantize_blocks,
                                                    quantize_blocks)
from repro_torch.kernels.delta_codec.ops import (stacked_flatten,
                                                 stacked_unflatten)
from repro_torch.kernels.fused_cnn.ops import (ForwardPolicy,
                                               make_eval_forward,
                                               make_stacked_epoch_fn,
                                               resolve_train_step)
from repro_torch.utils.tree import tree_clone, tree_leaves, tree_map

__all__ = ["RoundStats", "build_fused_round"]


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


def _codec_encode(stacked, params, block: int = BLOCK, bits: int = 8):
    """Quantize the stacked users' delta from the round-start params into
    the codec state ``(q (K, M, block), scales (K, M, 1))``: one launch
    over the ``(K·M, block)`` rows."""
    delta = tree_map(lambda s, p: s - p.unsqueeze(0), stacked, params)
    flat, _ = stacked_flatten(delta, block=block)
    k, rows, blk = flat.shape
    q, s = quantize_blocks(flat.reshape(k * rows, blk), bits=bits)
    return q.reshape(k, rows, blk), s.reshape(k, rows, 1)


def _codec_decode(q, s, stacked_like, params):
    """Dequantize the codec state back to a stacked params tree."""
    k, rows, blk = q.shape
    flat = dequantize_blocks(q.reshape(k * rows, blk),
                             s.reshape(k * rows, 1))
    delta = stacked_unflatten(flat.reshape(k, rows, blk), stacked_like)
    return tree_map(lambda d, p: p.unsqueeze(0) + d, delta, params)


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
                    q_new, s_new = _codec_encode(stacked, params, codec_block,
                                                 codec_bits)
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
                snap = _codec_decode(snap[0], snap[1], stacked, params)
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
