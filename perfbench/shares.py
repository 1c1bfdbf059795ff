"""Shares that several per-layer metrics read alike, each per cell under a
name of its own (``metrics/<name>.py`` imports its reader from here)."""


def idle(run):
    """The share (%) of the traced window in which no kernel or copy ran
    on the card: 1 - (union of the device's busy intervals) / (the
    window)."""
    if run.busy_s is None or not run.window_s or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def peak(run):
    """The window's model FLOPs (counted from shapes by the driver's
    ``work/<config>.py``) per second of the window, as a share (%) of the
    card's published rate in the precision the configuration computes in."""
    flops = run.work.get("model_flops")
    rate = run.work.get("peak_flops")
    if not flops or not rate or not run.window_s:
        return None
    return 100.0 * flops / run.window_s / rate
