"""The readings the limits of a cell's check are set from: the numbers the
check compares, for the program on each of ``--seeds`` and for the
control (the reference in the precision below the configuration's) on
each of ``--control-seeds``, each at the cell's own size, one JSON line a
seed.  On each control seed every fault of ``--faults`` is then planted
under the timed path in turn (``faults.py``), the timed path run again at
the cell's size, and the harness's ``check()`` read: ``fault_<kind>``
holds each number it compares.  Runs on the card; the benchmark's own
runs do not run it.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 4 5 6 --faults unchanged half \\
        [--out chiprun_out/readings.jsonl]
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from perfbench import faults, harness
    bench = harness.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell["traffic"])
    lines = []
    seeds = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(
            root=bench.root, cell=cell, config=bench.config(cell["config"]),
            traffic=traffic, seed=seed, device="cuda",
            work=bench.work(cell["config"]),
            reference=bench.reference(cell["config"]), peaks={})
        drv = bench.driver(traffic["driver"]).Driver(ctx)
        drv.setup()
        line = {"workload": args.workload, "seed": seed,
                **drv.readings(control)}
        if not control:
            line.pop("control", None)
        for kind in args.faults if control else ():
            with faults.planted(traffic["driver"], kind):
                drv.replay()
            line[f"fault_{kind}"] = {c.name: c.value for c in drv.check()}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
        del drv
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main())
