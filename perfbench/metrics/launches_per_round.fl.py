"""``launches_per_round.fl``: the fused-CNN and delta-codec kernel launches
of the window (the wrappers' own counters, ``kernels/_build.Library``)
per round of a sweep group.  A count: it repeats exactly."""


def read(run):
    rounds = run.counters.get("group_rounds")
    total = sum(run.counters.get("launches", {}).values())
    if not rounds or not total:
        return None
    return total / rounds
