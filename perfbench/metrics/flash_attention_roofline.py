"""``flash_attention_roofline``: the flash-attention kernel's share of its
roofline over the window: its bound over every batch of the window (one
launch a layer; causal FLOPs over the bf16 peak or q, k, v and o bytes
over HBM bandwidth, whichever is larger, from the batch shapes,
``work/<config>.py``) over its device time in the trace.

The device time is the kernel's records' mean duration times its launches
(the wrapper's counter): the profiler may lose a few records of a long
session."""
from perfbench.trace import short_name


def read(run):
    bound = run.work.get("flash_bound_s")
    prefix = run.work.get("flash_kernel")
    launches = run.counters.get("flash_launches")
    if not bound or not prefix or not launches:
        return None
    n = s = 0
    for name, _, d in run.device_events:
        if short_name(name).startswith(prefix):
            n, s = n + 1, s + d
    if not n:
        return None
    return 100.0 * bound / (s / n * launches / 1e9)
