"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, runs its set-up, its measured window and its check,
and prints the one result line.

Every file of a cell is found by name under ``<root>/perfbench/``:

- ``configs/<config>.json``: the configuration, as the cell runs it;
- ``traffic/<traffic>.json``: the traffic mix, as data; its ``driver``
  names the general generator that reads it, ``drivers/<driver>.py``;
- ``work/<config>.py``: the configuration's work counts from shapes;
- ``reference/<config>.py``: the configuration's plain reference;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A driver module defines ``Driver(ctx)`` with ``setup()``, ``window(seconds,
tracer)``, ``end_to_end(window_s)``, ``record()`` (counters and work for
the metric readers), ``release()`` (drops what the check does not need),
``check()`` (a list of ``Check``) and ``attempted``/``failed`` counts.
A metric module defines ``read(run) -> float | None``; None leaves the
metric out of the result line.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names the process may not hold once the window has
# closed: JAX, its pieces and the JAX package of the repo
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Check:
    """One number the check compares, with its limit (pass: value <=
    limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic as
    data, the run's seed and device, and the modules found by name."""
    root: Path
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    device: str
    work: Any
    reference: Any
    peaks: Dict
    log: Any = None

    def say(self, msg: str) -> None:
        if self.log is not None:
            self.log(msg)


@dataclass
class RunRecord:
    """What a per-layer metric's reader reads: the window, the device
    trace (``device_events``: (name, start_ns, dur_ns)), the driver's
    counters and work counts, the peaks of the device."""
    window_s: float
    busy_s: Optional[float] = None
    device_events: List = field(default_factory=list)
    counters: Dict = field(default_factory=dict)
    work: Dict = field(default_factory=dict)
    peaks: Dict = field(default_factory=dict)


def load_module(path: Path, name: Optional[str] = None):
    """A module from its file (names may hold ``-`` and ``.``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod_name = name or "perfbench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(path.anchor)))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` of ``root`` and the files its names lead to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.pb = self.root / "perfbench"

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config_entry(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return load_json(self.root / self.config_entry(name)["file"])

    def traffic(self, name: str) -> Dict:
        return load_json(self.pb / "traffic" / f"{name}.json")

    def driver(self, name: str):
        return load_module(self.pb / "drivers" / f"{name}.py")

    def work(self, config: str):
        return load_module(self.pb / "work" / f"{config}.py")

    def reference(self, config: str):
        return load_module(self.pb / "reference" / f"{config}.py")

    def metric_reader(self, name: str):
        return load_module(self.pb / "metrics" / f"{name}.py")

    def peaks(self) -> Dict:
        return load_json(self.pb / "peaks.json")

    def end_to_end(self, cell: str) -> List[Dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics whose readers run in the cell: those that
        list it, and those without a list that move an end-to-end metric
        the cell reports."""
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]


def device_peaks(peaks: Dict, kind: str) -> Dict:
    """The published peaks of the device named ``kind``
    (``torch.cuda.get_device_name``), or {} for a device not in the
    table: its rooflines and peak shares are then left out."""
    return peaks.get(kind, {})


def device_info(device: str) -> Dict:
    import torch
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: Optional[float] = None, log=None) -> Dict:
    """One run of a cell; returns the result line's object (``checks``
    last).  ``device="cpu"`` runs the program's CPU twins (the tests)."""
    import torch
    from perfbench import trace as tr
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Benchmark(root)
    cell = bench.cell(cell_name)
    traffic = bench.traffic(cell["traffic"])
    ctx = Context(root=bench.root, cell=cell,
                  config=bench.config(cell["config"]), traffic=traffic,
                  seed=int(seed), device=device,
                  work=bench.work(cell["config"]),
                  reference=bench.reference(cell["config"]), peaks={},
                  log=log)
    info = device_info(device)
    ctx.peaks = device_peaks(bench.peaks(), info["kind"])
    drv = bench.driver(traffic["driver"]).Driver(ctx)
    drv.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    tracer = tr.Tracer(trace, device)
    with tracer:
        t0 = time.perf_counter()
        drv.window(float(seconds), tracer)
        sync(device)
        window_s = time.perf_counter() - t0
    ctx.say(f"set-up {setup_s:.2f} s, window {window_s:.2f} s, profiler "
            f"stop {tracer.stop_s:.2f} s, trace read {tracer.read_s:.2f} s")
    info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                 if device == "cuda" else 0)
    ctx.say(f"memory_peak_bytes {info['memory_peak_bytes']} (set-up and "
            f"window, before the check)")
    values = {"setup_s": setup_s, **drv.end_to_end(window_s)}
    metrics = {}
    if trace:
        rec = RunRecord(window_s=tracer.window_s, busy_s=tracer.busy_s,
                        device_events=tracer.device_events,
                        counters=drv.counters(), work=drv.work_record(),
                        peaks=ctx.peaks)
        info["busy_s"] = tracer.busy_s
        info["window_s"] = tracer.window_s
        for m in bench.per_layer(cell_name):
            v = bench.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell_name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    attempted, failed = drv.attempted, drv.failed
    drv.release()
    t1 = time.perf_counter()
    checks = drv.check()
    ctx.say(f"check {time.perf_counter() - t1:.2f} s")
    out = {"correct": bool(checks) and all(c.ok for c in checks),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": info}
    if trace:
        out["breakdown"] = tracer.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out


def forbidden_modules() -> List[str]:
    """Modules of ``FORBIDDEN`` in ``sys.modules``, by whole top-level
    name (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Benchmark(ROOT)
    chips = bench.cell(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    log = lambda msg: print(f"perfbench: {msg}", file=sys.stderr,  # noqa
                            flush=True)
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", ROOT, t_start, log)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found} once the window has "
              f"closed; no result", file=sys.stderr)
        return 3
    print(f"perfbench: memory_peak_bytes {out['device']['memory_peak_bytes']}")
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
