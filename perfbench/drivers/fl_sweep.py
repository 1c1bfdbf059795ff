"""The general generator of FL sweep panels: runs Fig. 3 panels back to
back through the port's ``Experiment.from_spec(spec).run(engine="sweep")``.

The traffic file gives the panel's grid (``schemes``, ``distributions``,
``b``, ``tau_max``, ``bandwidth_ratio``; an empty list keeps the
configuration's value), ``seeds_per_panel``, ``rounds``, the rounds of the
warm-up panel, how many rows and rounds the check compares
(``check_rows``, ``check_rounds``, ``late_rounds``) and the limits of the check for each
configuration.  Panel ``i`` of a run takes the simulation seeds
``inputs.panel_seeds(seed, i, n)``; every simulation's draws come from
``inputs.PanelStream`` through the sweep's ``stream_factory``.  The window closes at the end of the first panel that
ends after ``--seconds``.

The check runs the configuration's reference on ``check_rows`` rows drawn
from the seed among all the rows the window simulated, every round of
each, and compares each row's per-round counts and bytes over every
round, its test loss over the first ``check_rounds`` rounds, and its test
accuracy averaged over the last ``late_rounds``: f32 trajectories fork
after a few rounds (see PERF.md), and forks converge alike, while a
global state that is not carried from round to round stays near its
first rounds' accuracy.
"""
from __future__ import annotations

import random
from dataclasses import replace
from typing import Dict, List

import numpy as np

from perfbench import inputs
from perfbench.harness import Check
from perfbench.trace import Tracer

COUNTS = ("selected", "arrived", "rescued", "delayed", "dropped")


def _worst(x) -> float:
    """The largest of ``x``; infinite where any value is not a number, so
    that a NaN fails every limit."""
    x = np.asarray(x, dtype=np.float64)
    return float("inf") if np.isnan(x).any() else float(np.max(x))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.panels: List[Dict] = []
        self.attempted = self.failed = 0
        self.launches: Dict[str, int] = {}
        self.want: Dict[tuple, Dict] = {}     # the reference's rows, by row

    # -- the program's inputs --------------------------------------------------
    def _base(self):
        from repro_torch.core.channel_lib import ChannelParams
        from repro_torch.core.hsfl import HSFLConfig
        h = dict(self.cfg["hsfl"])
        h["flops_range"] = tuple(h["flops_range"])
        ch = dict(self.cfg["channel"])
        for k in ("k_db_range", "uav_z_range"):
            ch[k] = tuple(ch[k])
        return HSFLConfig(rounds=int(self.traffic["rounds"]),
                          channel=ChannelParams(**ch), **h)

    def _spec(self, seeds, rounds: int):
        from repro_torch.core.sweep import SweepSpec
        t = self.traffic
        schemes = tuple(s if isinstance(s, str) else (s[0], dict(s[1]))
                        for s in t["schemes"])
        return SweepSpec(base=replace(self.base, rounds=rounds),
                         seeds=tuple(seeds), schemes=schemes,
                         distributions=tuple(t["distributions"]),
                         b=tuple(float(x) for x in t["b"]),
                         tau_max=tuple(float(x) for x in t["tau_max"]),
                         bandwidth_ratio=tuple(float(x) for x in
                                               t["bandwidth_ratio"]))

    def _stream(self, cfg, device):
        return inputs.PanelStream(cfg.seed, device,
                                  self.cfg["model"]["param_shapes"])

    def _panel(self, seeds, rounds: int, tracer):
        from repro_torch.api import Experiment
        ex = Experiment.from_spec(self._spec(seeds, rounds))
        dev = None if self.ctx.device == "cuda" else self.ctx.device
        with tracer.span("perfbench.panel"):
            return ex.run(engine="sweep", mesh=None, device=dev,
                          stream_factory=self._stream)

    # -- the harness's calls ---------------------------------------------------
    def setup(self) -> None:
        self.base = self._base()
        n = int(self.traffic["seeds_per_panel"])
        seeds = [inputs.derive_seed(self.ctx.seed, "warmup", j)
                 for j in range(n)]
        self._panel(seeds, int(self.traffic["warmup_rounds"]),
                    Tracer(False, self.ctx.device))

    def _launch_counts(self) -> Dict[str, int]:
        from repro_torch.kernels.delta_codec import kernel as dk
        from repro_torch.kernels.fused_cnn import kernel as fk
        return {**fk.LAUNCHES, **dk.LAUNCHES}

    def window(self, seconds: float, tracer) -> None:
        import time
        from repro_torch.core import sweep
        tracer.wrap(sweep, "build_sim_arrays", "perfbench.build_sim_arrays")
        n = int(self.traffic["seeds_per_panel"])
        rounds = int(self.traffic["rounds"])
        start = self._launch_counts()
        t0 = time.perf_counter()
        i = 0
        while True:
            seeds = inputs.panel_seeds(self.ctx.seed, i, n)
            tp = time.perf_counter()
            res = self._panel(seeds, rounds, tracer)
            self.ctx.say(f"panel {i}: {time.perf_counter() - tp:.3f} s, "
                         f"round loops {sum(g.run_s for g in res.groups):.3f}"
                         f" s")
            rows = sum(len(g.sims) * len(g.cfgs) for g in res.groups)
            self.attempted += rows
            self.failed += sum(int(np.sum(~np.isfinite(
                g.metrics["test_loss"]).any(axis=-1))) for g in res.groups)
            self.panels.append({"seeds": seeds, "result": res, "rows": rows,
                                "rounds": rounds,
                                "run_s": sum(g.run_s for g in res.groups),
                                "groups": len(res.groups)})
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        end = self._launch_counts()
        self.launches = {k: end[k] - start[k] for k in end}

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        row_rounds = sum(p["rows"] * p["rounds"] for p in self.panels)
        return {"fl_row_rounds_per_s": row_rounds / window_s}

    def counters(self) -> Dict:
        return {"launches": dict(self.launches),
                "group_rounds": sum(p["groups"] * p["rounds"]
                                    for p in self.panels),
                "run_s": sum(p["run_s"] for p in self.panels)}

    def work_record(self) -> Dict:
        """The window's work from shapes: model FLOPs and the fused-CNN
        kernels' bound seconds by kernel (``work/<config>.py``)."""
        w = self.ctx.work
        h = self.cfg["hsfl"]
        flops, bound = 0.0, {}
        for p in self.panels:
            for g in p["result"].groups:
                rows = len(g.sims) * len(g.cfgs)
                flops += p["rounds"] * w.row_round_flops(self.cfg, rows)
                if not self.ctx.peaks:          # no table for this device
                    continue
                for name, s in w.group_round_bound_s(
                        self.cfg, rows, self.ctx.peaks).items():
                    bound[name] = bound.get(name, 0.0) + p["rounds"] * s
        return {"model_flops": flops, "kernel_bound_s": bound,
                "kernels": w.KERNELS, "peak_flops": self.ctx.peaks.get(
                    h["precision"] + "_flops_per_s")}

    def release(self) -> None:
        """Keep each panel's metrics and final params; nothing else of the
        program is held."""

    # -- the check ---------------------------------------------------------------
    def _rows(self):
        """Every (panel, group, sim, config) row the window simulated."""
        out = []
        for pi, p in enumerate(self.panels):
            for gi, g in enumerate(p["result"].groups):
                for si in range(len(g.sims)):
                    for ci in range(len(g.cfgs)):
                        out.append((pi, gi, si, ci))
        return out

    def reference_row(self, row, precision: str = "f32") -> Dict:
        """The reference's answers of one row, every round (kept: a row
        the check compares again after a replay is not simulated twice)."""
        pi, gi, si, ci = row
        g = self.panels[pi]["result"].groups[gi]
        seed, dist = g.sims[si]
        c = g.cfgs[ci]
        key = (g.scheme, self.panels[pi]["rounds"], seed, dist, c["b"],
               c["tau_max"], c["bandwidth_ratio"], precision)
        if key not in self.want:
            self.want[key] = self.ctx.reference.run_row(
                self.cfg, *key[:-1], self.ctx.device, precision)
        return self.want[key]

    def program_row(self, row) -> Dict:
        """The program's answers of one row: its per-round metrics."""
        pi, gi, si, ci = row
        g = self.panels[pi]["result"].groups[gi]
        return {k: v[si, ci] for k, v in g.metrics.items()}

    def compare(self, got: Dict, want: Dict) -> Dict[str, float]:
        """The numbers of one row: the rounds' count mismatches and the
        largest relative gap of their bytes, over every round; the largest
        relative gap of the test loss over the first ``check_rounds``
        rounds; the gap of the test accuracy averaged over the last
        ``late_rounds``."""
        n, late = (int(self.traffic["check_rounds"]),
                   int(self.traffic["late_rounds"]))
        counts = sum(int(np.sum(np.asarray(got[k]).astype(np.int64)
                                != np.asarray(want[k]).astype(np.int64)))
                     for k in COUNTS)
        rel = lambda a, b: _worst(np.abs(  # noqa: E731
            np.asarray(a, np.float64) - b) / np.maximum(np.abs(b), 1e-30))
        acc = lambda a: np.mean(np.asarray(a, np.float64)[-late:])  # noqa
        return {"counts_diff": float(counts),
                "bytes_diff": rel(got["bytes_sent"], want["bytes_sent"]),
                "loss_rel": rel(got["test_loss"][:n], want["test_loss"][:n]),
                "late_acc_gap": _worst(abs(acc(got["test_acc"])
                                           - acc(want["test_acc"])))}

    def sample_rows(self) -> list:
        rows = self._rows()
        k = min(int(self.traffic["check_rows"]), len(rows))
        return random.Random(inputs.derive_seed(self.ctx.seed, "check")) \
            .sample(rows, k)

    def check(self) -> List[Check]:
        limits = self.traffic["limits"][self.ctx.cell["config"]]
        worst: Dict[str, float] = {k: 0.0 for k in limits}
        for row in self.sample_rows():
            got = self.compare(self.program_row(row), self.reference_row(row))
            for k in worst:
                worst[k] = max(worst[k], got[k])
        return [Check(k, worst[k], float(limits[k])) for k in limits]

    def readings(self, control: bool) -> Dict[str, Dict[str, float]]:
        """The numbers the check compares, after one panel at the cell's
        size (``calibrate.py``): the program's against the reference, and
        with ``control`` the control's (the reference in TF32) against it;
        each the worst over the sampled rows."""
        self.window(0.0, Tracer(False, self.ctx.device))
        out: Dict[str, Dict[str, float]] = {"program": {}, "control": {}}
        for row in self.sample_rows():
            want = self.reference_row(row)
            pairs = [("program", self.program_row(row))]
            if control:
                pairs.append(("control", self.reference_row(row, "tf32")))
            for kind, got in pairs:
                for k, v in self.compare(got, want).items():
                    out[kind][k] = max(out[kind].get(k, 0.0), v)
        return out

    def replay(self) -> None:
        """Run the first panel again through the timed path, outside any
        window (``calibrate.py``, with a fault planted): the check then
        compares the same rows."""
        self.panels = []
        self.window(0.0, Tracer(False, self.ctx.device))
