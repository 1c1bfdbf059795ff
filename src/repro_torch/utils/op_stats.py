"""What one rank of a program computes, moves and holds, counted op by op
as it runs: the port's counterpart of ``repro/utils/hlo.py``'s
``collective_stats`` (collectives parsed from compiled HLO) and
``compiled_memory_stats`` (``Compiled.memory_analysis()``).

``ProgramStats`` is a ``TorchDispatchMode``.  It lets DTensor desugar
first (it declines every op on a ``DTensor``), so it sees each rank's
local ops: the aten ops on local shards and the functional collectives
DTensor issues (``_c10d_functional.*``).  It runs the same on real
tensors, on fake ones (``FakeTensorMode``: shapes only, no memory, no
data) and on plain tensors of one device, so a dry run on a fake world
and a real run count alike.  Per rank it records:

- ``flops``: the products' FLOPs, by ``torch.utils.flop_counter``'s
  formulas (mm, bmm, addmm, baddbmm, convolutions, attention); every
  other op counts none;
- ``bytes``: HBM traffic as the sum of each op's local input and output
  bytes, an op at a time, views and collectives excluded;
- ``collectives``: per kind (all-gather, all-reduce, reduce-scatter,
  all-to-all, and broadcast where one runs) the count and the bytes of
  its outputs, as the reference counts them;
- ``memory``: ``argument_size_in_bytes`` (the storages of the inputs
  named by ``hold``), ``output_size_in_bytes`` (the storages of the
  outputs named by ``outputs`` not among the arguments'),
  ``peak_memory_in_bytes`` (the most bytes of live storage at any point,
  the arguments, the saved activations, the gradients and every scratch
  buffer included), and ``temp_size_in_bytes`` (the peak less arguments
  and outputs).

With ``extrapolate=True`` (the dry run's) a recurrence that the model
code marks with ``recurrence`` (the WKV scan, mamba's selective scan) is
not run step by step: its counts are measured at two short lengths and
extended affinely in S (see ``recurrence``).

These differ in kind from XLA's ``cost_analysis``: the FLOPs are the
products' only (XLA counts elementwise ops too), and the bytes are those
of an eager program with no fusion (XLA's fused program reads and writes
less).  So the port's records and the reference's are not compared with
each other.
"""
from __future__ import annotations

import contextlib
import math
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_propagation() -> bool:
    """True inside DTensor's sharding propagation (its
    ``_propagate_tensor_meta*`` in ``_sharding_prop.py``), which reuses the
    caller's fake mode, so only the stack tells its ops from the rank's."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_name.startswith("_propagate_tensor_meta") and \
                code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class ProgramStats(TorchDispatchMode):
    """Count one rank's FLOPs, HBM bytes, collectives and live storage.

    ``hold`` is the program's inputs (any tree of tensors or DTensors):
    their storages are live from the start, as the caller holds them.
    Read ``record()`` after the ``with`` block; ``outputs(tree)`` names
    the program's outputs for the output size."""

    def __init__(self, hold: Any = None, extrapolate: bool = False):
        super().__init__()
        self.extrapolate = extrapolate
        self._paused = 0
        self._measured: Dict[Any, Any] = {}     # recurrences, by call
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, float]] = {
            k: {"count": 0, "bytes": 0.0} for k in KINDS}
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._args = set()
        for t in _tensors(hold):
            self._track(_local(t))
        self._args = set(self._live)
        self.argument_bytes = self.live_bytes

    # -- live storage ------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

        def gone(_ref, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, gone)

    def outputs(self, tree: Any) -> None:
        """Name the program's outputs: the bytes of their local storages
        that are not the arguments' own."""
        seen = set()
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if id(st) in self._args or id(st) in seen:
                continue
            seen.add(id(st))
            self.output_bytes += st.nbytes()

    # -- the mode ------------------------------------------------------------

    def __enter__(self):
        if self.extrapolate:
            _EXTRAPOLATING.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.extrapolate:
            _EXTRAPOLATING.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Ops inside pass through uncounted and untracked."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add(self, counts: Dict[str, float]) -> None:
        """Add counts made elsewhere (``_counts``' keys)."""
        self.flops += counts["flops"]
        self.bytes += counts["bytes"]
        for kind in KINDS:
            rec = self.collectives[kind]
            rec["count"] += counts[f"{kind}/count"]
            rec["bytes"] += counts[f"{kind}/bytes"]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        # let DTensor turn the op into local ops and collectives first:
        # those come back through this mode
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        # DTensor's sharding propagation runs the op on fake tensors of the
        # global shapes to learn the output's: not the rank's work
        if _in_propagation():
            return func(*args, **kwargs)
        ns, _, op = func._schema.name.partition("::")
        if ns == "_c10d_functional" and op not in COLLECTIVE_KINDS:
            # a wait, or the autograd wrapper of a collective's output:
            # no traffic of its own.  Eager waits in place; a fake wait
            # would make a new tensor
            if op == "wait_tensor" and isinstance(args[0], FakeTensor):
                return args[0]
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if ns == "_c10d_functional":
            kind = COLLECTIVE_KINDS[op]
            rec = self.collectives.setdefault(kind, {"count": 0,
                                                     "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += float(sum(_nbytes(t) for t in outs))
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
            if outs and not func.is_view:
                self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
                self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    # -- the record ----------------------------------------------------------

    def record(self) -> Dict[str, Any]:
        peak = self.peak_bytes
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "coll_bytes": float(sum(v["bytes"]
                                    for v in self.collectives.values())),
            "memory": {
                "argument_size_in_bytes": int(self.argument_bytes),
                "output_size_in_bytes": int(self.output_bytes),
                "temp_size_in_bytes": int(max(peak - self.argument_bytes
                                              - self.output_bytes, 0)),
                "peak_memory_in_bytes": int(peak),
            },
        }


# ---------------------------------------------------------------------------
# recurrences counted at two short lengths
# ---------------------------------------------------------------------------

_EXTRAPOLATING: List[ProgramStats] = []
# the calibration lengths: step 1 differs from the rest (a size-1 time dim
# lets some ops skip a copy), every later step costs the same
_A = 2


def _counts(stats: ProgramStats) -> Dict[str, float]:
    out = {"flops": float(stats.flops), "bytes": float(stats.bytes),
           "peak": float(stats.peak_bytes), "live": float(stats.live_bytes)}
    for kind in KINDS:
        rec = stats.collectives.get(kind, {"count": 0, "bytes": 0.0})
        out[f"{kind}/count"] = float(rec["count"])
        out[f"{kind}/bytes"] = float(rec["bytes"])
    return out


def _like(t: torch.Tensor, n: Optional[int], grad: bool) -> torch.Tensor:
    """A zero tensor like ``t``, its time dim (1) of length ``n`` (``None``:
    as it is), laid out as ``t`` would be at that length: a stride that
    spans the time dim scales with it, so that a slice of a wider tensor
    stays one and dims that merge into a view in ``t`` merge here too."""
    shape, stride = list(t.shape), list(t.stride())
    if n is not None:
        S, unit = shape[1], shape[1] * stride[1]
        shape[1] = n
        stride = [st // S * n if d != 1 and unit and st >= unit
                  and st % unit == 0 else st for d, st in enumerate(stride)]
    out = torch.empty_strided(shape, stride, dtype=t.dtype,
                              device=t.device).zero_()
    return out.requires_grad_(grad)


class _Plan:
    """One recurrence call: ``fn``, which args and outputs carry time on
    dim 1, the chunk ``period`` of its loop (None: none), the counting
    ``stats``, and the length S."""

    def __init__(self, fn, time_args, time_outs, period, stats, S):
        self.fn, self.time_args, self.time_outs = fn, time_args, time_outs
        self.period, self.stats, self.S = period, stats, S

    def chunked(self) -> bool:
        return self.period is not None and self.S > self.period

    def lengths(self) -> List[int]:
        """Two lengths a, a + 1 (a = 2: step 1 alone differs); past one
        chunk of a chunked loop, a = P + 2 (its chunks are strided views
        of the whole, whose steps cost what a lone chunk's do not) and a
        third length 2P + 2 for a chunk's own cost."""
        if not self.chunked():
            return [_A, _A + 1]
        P = self.period
        return [P + _A, P + _A + 1, 2 * P + _A]

    def inputs(self, args, n, needs):
        return [(_like(a, n if i in self.time_args else None, needs[i])
                 if isinstance(a, torch.Tensor) else a)
                for i, a in enumerate(args)]

    def extend(self, at: Dict[int, Dict[str, float]]) -> Dict[str, float]:
        """X(S) = X(a) + (S-a)·(X(a+1) - X(a)), plus, for a chunked loop,
        (chunks - 2) times a chunk's own cost X(2P+a) - X(a) - P·step."""
        S = self.S
        a, b = self.lengths()[:2]
        out = {}
        for key, xa in at[a].items():
            step = at[b][key] - xa
            val = xa + (S - a) * step
            if self.chunked():
                P = self.period
                chunk = at[2 * P + _A][key] - xa - P * step
                val += (math.ceil(S / P) - 2) * chunk
            out[key] = val
        return out

    def key(self, args, needs, grads=None):
        """What the counts depend on: the same call in every layer is
        measured once."""
        return (self.fn, self.S, tuple(needs), grads, tuple(
            (a.shape, a.dtype, a.stride()) if isinstance(a, torch.Tensor)
            else (a[0], a[1], a[3]) if isinstance(a, tuple) else a
            for a in args))


def _own_saves():
    """Saved tensors kept as they are: a checkpointed layer's hooks (which
    drop them in its first pass) must not reach the measured copies."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)


def _outs(out) -> List[Any]:
    return list(out) if isinstance(out, tuple) else [out]


class _Extrapolated(torch.autograd.Function):
    """A recurrence's outputs at full length, with its forward and
    backward counted by extrapolation: the outputs are empty tensors of
    the true shapes, tracked as live; a placeholder of the bytes the
    recurrence's autograd graph holds stands for its saved tensors (saved
    for backward, so a checkpointed layer drops and recomputes it as it
    would the real ones); the peak takes the extended transient."""

    @staticmethod
    def forward(ctx, plan: _Plan, *args):
        ctx.set_materialize_grads(False)
        stats = plan.stats
        needs = ctx.needs_input_grad[1:]
        record = any(needs)
        key = plan.key(args, needs)
        with stats.paused():
            if key not in stats._measured:
                at = {}
                for n in plan.lengths():
                    ins = plan.inputs(args, n, needs)
                    with _own_saves(), ProgramStats() as inner, \
                            torch.enable_grad() if record else \
                            contextlib.nullcontext():
                        out = plan.fn(*ins)
                        at[n] = _counts(inner)
                    shapes = [(o.shape, o.dtype, o.device)
                              for o in _outs(out)]
                    del out, ins
                stats._measured[key] = (plan.extend(at), shapes)
            ext, shapes = stats._measured[key]
            entry = stats.live_bytes
            outs = []
            for i, (shape, dtype, dev) in enumerate(shapes):
                shape = list(shape)
                if i in plan.time_outs:
                    shape[1] = plan.S
                outs.append(torch.empty(shape, dtype=dtype, device=dev))
            held = int(max(0.0, ext["live"] - sum(_nbytes(o) for o in outs)))
            residual = torch.empty(held if record else 0,
                                   dtype=torch.uint8, device=outs[0].device)
        stats.add(ext)
        stats.peak_bytes = max(stats.peak_bytes, entry + int(ext["peak"]))
        for t in outs + [residual]:
            stats._track(t)
        ctx.plan = plan
        ctx.args = [(a.shape, a.dtype, a.device, a.stride())
                    if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(residual)
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        plan, stats = ctx.plan, ctx.plan.stats
        needs = ctx.needs_input_grad[1:]
        if all(g is None for g in grads):
            return (None,) * (1 + len(needs))
        key = plan.key(ctx.args, needs, tuple(g is None for g in grads))
        with stats.paused():
            specs = [torch.empty_strided(a[0], a[3], dtype=a[1], device=a[2])
                     if isinstance(a, tuple) else a for a in ctx.args]
            if key not in stats._measured:
                stats._measured[key] = _measure_backward(plan, specs, needs,
                                                         grads)
            ext = stats._measured[key]
            entry = stats.live_bytes
            got = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                   if need else None for a, need in zip(specs, needs)]
        stats.add(ext)
        stats.peak_bytes = max(stats.peak_bytes, entry + int(ext["peak"]))
        for t in got:
            if t is not None:
                stats._track(t)
        return (None, *got)


def _measure_backward(plan: _Plan, specs, needs, grads) -> Dict[str, float]:
    """The backward's counts at the plan's lengths, extended.  The
    forward runs under the counter too, so that the saved tensors the
    backward frees as it goes are tracked; then the backward's counts
    alone, its peak over what it started with."""
    at = {}
    for n in plan.lengths():
        ins = plan.inputs(specs, n, needs)
        wrt = [x for x, need in zip(ins, needs) if need]
        with _own_saves(), ProgramStats() as inner:
            with torch.enable_grad():
                outs = _outs(plan.fn(*ins))
            pairs = [(o, torch.zeros_like(o)) for o, g in zip(outs, grads)
                     if g is not None]
            before = _counts(inner)
            inner.peak_bytes = inner.live_bytes
            torch.autograd.grad([o for o, _ in pairs], wrt,
                                [g for _, g in pairs], allow_unused=True)
            at[n] = {k: v - before["live" if k == "peak" else k]
                     for k, v in _counts(inner).items()}
        del outs, pairs, wrt, ins
    return plan.extend(at)


def recurrence(fn: Callable, time_args: Sequence[int],
               time_outs: Sequence[int] = (0,),
               period: Optional[int] = None) -> Callable:
    """``fn`` — a loop over time, the same ops on the same shapes each
    step, on the tensors at ``time_args`` (time on dim 1), returning
    time-major outputs at ``time_outs`` — as the dry run counts it.

    Outside a ``ProgramStats(extrapolate=True)`` (the dry run's) it is
    ``fn`` itself.  Inside one, a call of S steps runs ``fn`` at lengths
    2 and 3 (for a loop that works in chunks of ``period`` steps, where
    S exceeds one: P + 2, P + 3 and 2P + 2) with its counter paused, and
    counts, forward and backward, FLOPs, HBM bytes and collectives
    X(a) + (S-a)·(X(a+1) - X(a)) (+ the chunks' own cost): equal to the
    full loop's own counts, since each step costs the same (step 1 alone
    differs).  Each distinct call (the same in every layer) is measured
    once.  Its outputs are empty tensors of the true shapes (no data:
    the dry run's are fake), live as the real ones would be, with the
    bytes its autograd graph holds, and the peak takes the extended
    transient.  For the dry run's fake tensors only."""
    time_args, time_outs = tuple(time_args), tuple(time_outs)

    def run(*args):
        stats = _EXTRAPOLATING[-1] if _EXTRAPOLATING else None
        S = args[time_args[0]].shape[1]
        if stats is None or stats._paused or S <= _A + 1:
            return fn(*args)
        return _Extrapolated.apply(
            _Plan(fn, time_args, time_outs, period, stats, S), *args)

    return run
