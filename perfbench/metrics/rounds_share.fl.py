"""``rounds_share.fl``: the share (%) of the window the sweep spent in its
groups' round loops, from the program's own timer (``GroupResult.run_s``:
a synchronize, then the host clock around the round loop and the one read
of its metrics), summed over every group of the window.  The rest is host
preparation (``hsfl.build_sim_arrays``, compiling the spec) and the
benchmark's own loop."""


def read(run):
    run_s = run.counters.get("run_s")
    if not run_s or not run.window_s:
        return None
    return 100.0 * run_s / run.window_s
