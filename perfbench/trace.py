"""The traced window: ``torch.profiler``'s device records over the whole
measured window, and the benchmark's own host spans.

The profiler records the card's activity only (kernels, copies): host
ops would add several records per launch, and a window of 10^6 launches
then took minutes to stop and read.  The window is bounded on the
device's timeline by two marker launches, one as it opens (the card
idle) and one as it closes (the card idle again).  The device's busy
time is the union of the intervals in which a kernel or copy ran
(``busy_s``) between them; the idle gaps are named by the innermost host
span (``span``, ``wrap``) open at each gap's middle, the host's clock
mapped onto the device's by the first marker.

Records are read raw (``kineto_results``, as ``chip_smoke.py`` reads
them): the stock profile would turn every record into a Python event.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

TOP = 10


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespace, template and
    parameter lists."""
    name = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].strip() or kernel


def union_ns(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged (start, end) intervals, in order."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def name_gaps(gaps, spans) -> Dict[str, float]:
    """Seconds of idle device time by the innermost span open at each
    gap's middle; ``spans`` are (start, end, name), properly nested."""
    out: Dict[str, float] = {}
    spans = sorted(spans, key=lambda h: (h[0], -h[1]))
    stack: List = []
    j = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        label = stack[-1][2] if stack else "(outside every span)"
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return out


class Tracer:
    """Profiles the window when ``enabled``; otherwise every method is a
    no-op, so an untraced run pays nothing."""

    def __init__(self, enabled: bool, device: str):
        self.enabled = bool(enabled)
        self.device = device
        self.window_s = None
        self.busy_s = None
        self.device_events: List[Tuple[str, int, int]] = []
        self.spans: List[Tuple[int, int, str]] = []
        self._gaps: Dict[str, float] = {}
        self._prof = None
        self._t0 = 0
        self._patches: List = []
        self.stop_s = self.read_s = 0.0

    # -- spans ---------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """A host span ``name`` (host clock, ns), kept when tracing."""
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def wrap(self, module, attr: str, name: str) -> None:
        """While tracing, run ``module.attr`` inside a span ``name``; the
        attribute is restored when the window closes.  A missing attribute
        is left alone (the span is then absent)."""
        if not self.enabled or not hasattr(module, attr):
            return
        fn = getattr(module, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        self._patches.append((module, attr, fn))
        setattr(module, attr, spanned)

    # -- the window ----------------------------------------------------------
    @staticmethod
    def _marker():
        import torch
        torch.cuda.synchronize()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()

    def __enter__(self):
        if not self.enabled:
            return self
        if self.device == "cuda":
            import torch

            class RawProfile(torch.autograd.profiler.profile):
                """Keeps the raw records: nothing here reads the Python
                events the stock profile makes of them."""

                def _parse_kineto_results(self, result):
                    return []

            torch.cuda.synchronize()
            self._prof = RawProfile(use_kineto=True, use_cpu=False,
                                    use_device="cuda")
            self._prof.__enter__()
        self._t0 = time.time_ns()
        if self._prof is not None:
            self._marker()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        t1 = time.time_ns()
        if self._prof is not None:
            self._marker()
            t0 = time.perf_counter()
            self._prof.__exit__(*exc)
            self.stop_s = time.perf_counter() - t0
        for module, attr, fn in self._patches:
            setattr(module, attr, fn)
        self._patches = []
        if exc[0] is None:
            t0 = time.perf_counter()
            if self._prof is None:                 # the CPU: no device
                self.window_s, self.busy_s = (t1 - self._t0) / 1e9, 0.0
                self._gaps = name_gaps([(self._t0, t1)], self.spans)
            else:
                self._read(self._prof.kineto_results.events())
            self.read_s = time.perf_counter() - t0
        self._prof = None
        return False

    def _read(self, events) -> None:
        from torch.autograd import DeviceType
        dev = []
        for ev in events:
            if ev.device_type() != DeviceType.CUDA or ev.is_hidden_event():
                continue
            name = ev.name()
            if not name.startswith("Activity Buffer"):
                dev.append((name, ev.start_ns(), ev.duration_ns()))
        if len(dev) < 2:
            raise RuntimeError("the profile holds no device activity")
        dev.sort(key=lambda e: e[1])
        (_, w0, _), (_, last, d) = dev[0], dev[-1]      # the two markers
        w1 = last + d
        self.window_s = (w1 - w0) / 1e9
        self.device_events = dev[1:-1]
        busy = union_ns([(s, s + d) for _, s, d in self.device_events])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        gaps, prev = [], w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        shift = w0 - self._t0          # host clock -> the device timeline
        self._gaps = name_gaps(gaps, [(s + shift, e + shift, n)
                                      for s, e, n in self.spans])

    def breakdown(self) -> Dict:
        """The device operations that took most time and the idle time by
        what the host was doing: at most ``TOP`` entries each, seconds."""
        ops: Dict[str, float] = {}
        for n, _, d in self.device_events:
            k = short_name(n)
            ops[k] = ops.get(k, 0.0) + d / 1e9
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(self._gaps)}
