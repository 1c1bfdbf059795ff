"""Faults planted under the timed path, for the check's tests and for
``calibrate.py``'s readings at a cell's own size.  ``FAULTS[driver][kind]()``
gives ``(module, attribute, replacement)``: setting the attribute to the
replacement plants the fault; ``planted`` does so and puts it back.

- ``unchanged``: a step returns its state unchanged (FL: each local epoch
  gives the users' params back as it got them; prefill: every layer gives
  its input back);
- ``half``: half of the batch left out, the mean taken over the rest (FL:
  each SGD step on the first half of its batch; prefill: the first half of
  the sequences run, the rest copied from them);
- ``stale`` (FL): a round's aggregate is not carried, so every round starts
  from the group's initial params;
- ``altered``: an answer altered where it is produced (FL: every row's
  arrived count of its last round, one higher where the metrics are read;
  prefill: the logits of the first sequence's last position are those of
  the last sequence's first);
- ``unwritten`` (prefill): that position's logits NaN.
"""
from __future__ import annotations

import contextlib


def _fl_epoch(kind):
    import repro_torch.core.fused_round as fr
    make = fr.make_stacked_epoch_fn

    def broken(policy, lr):
        epoch = make(policy, lr)

        def run(stacked, xs, ys):
            if kind == "unchanged":
                return stacked
            half = xs.shape[2] // 2
            return epoch(stacked, xs[:, :, :half].contiguous(),
                         ys[:, :, :half].contiguous())
        return run
    return fr, "make_stacked_epoch_fn", broken


def _fl_stale():
    import repro_torch.core.sweep as sw

    def stale(round_fn, carry, streams, data, cfg, rounds):
        params0, out = carry.params, []
        for t in range(1, rounds + 1):
            carry, m = round_fn(carry._replace(params=params0), t, streams,
                                data, cfg)
            out.append(m)
        return carry, out
    return sw, "_scan_rounds", stale


def _fl_altered():
    import repro_torch.core.sweep as sw
    read = sw._metrics_numpy

    def altered(allm, s, c):
        out = read(allm, s, c)
        out["arrived"] = out["arrived"].copy()
        out["arrived"][..., -1] += 1
        return out
    return sw, "_metrics_numpy", altered


def _prefill(kind):
    import torch

    import repro_torch.models.transformer as tf
    if kind == "unchanged":
        return tf, "_layer_full", lambda p, cfg, x, pos, opts: (
            x, torch.zeros((), device=x.device))
    full = tf.forward_full

    def broken(params, cfg, inputs, opts=None):
        tok = inputs["tokens"]
        if kind == "half":
            half = max(1, tok.shape[0] // 2)
            logits, aux = full(params, cfg, {"tokens": tok[:half]}, opts)
            reps = -(-tok.shape[0] // half)
            return logits.repeat(reps, 1, 1)[:tok.shape[0]], aux
        logits, aux = full(params, cfg, inputs, opts)
        logits = logits.clone()
        logits[0, -1] = (logits[-1, 0] if kind == "altered"
                         else float("nan"))
        return logits, aux
    return tf, "forward_full", broken


FAULTS = {
    "fl_sweep": {"unchanged": lambda: _fl_epoch("unchanged"),
                 "half": lambda: _fl_epoch("half"),
                 "stale": _fl_stale,
                 "altered": _fl_altered},
    "prefill": {"unchanged": lambda: _prefill("unchanged"),
                "half": lambda: _prefill("half"),
                "altered": lambda: _prefill("altered"),
                "unwritten": lambda: _prefill("unwritten")},
}


@contextlib.contextmanager
def planted(driver: str, kind: str):
    """The fault ``kind`` of the driver's timed path, planted while the
    block runs."""
    module, attr, broken = FAULTS[driver][kind]()
    old = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, old)
