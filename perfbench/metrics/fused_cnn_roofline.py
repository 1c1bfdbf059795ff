"""``fused_cnn_roofline``: the four blocked fused-CNN kernels' share of
their roofline over the window: their summed bound time (each launch's
FLOPs over the f32 peak or its bytes over HBM bandwidth, whichever is
larger, from the launch shapes, ``work/paper-cnn.py``) over their summed
device time in the trace.

A kernel's device time is its records' mean duration times its launches
(the wrappers' counters): the profiler may lose a few records of a long
session, and a time summed over the records it kept would read low."""
from perfbench.trace import short_name


def read(run):
    kernels = run.work.get("kernels", {})
    bound = run.work.get("kernel_bound_s", {})
    launches = run.counters.get("launches", {})
    dur = {}
    for name, _, d in run.device_events:
        k = short_name(name)
        n, s = dur.get(k, (0, 0))
        dur[k] = (n + 1, s + d)
    b_total = t_total = 0.0
    for counter, kernel in kernels.items():
        n, s = dur.get(kernel, (0, 0))
        if not n or not launches.get(counter):
            continue
        t_total += s / n * launches[counter] / 1e9
        b_total += bound.get(counter, 0.0)
    if t_total <= 0 or b_total <= 0:
        return None
    return 100.0 * b_total / t_total
