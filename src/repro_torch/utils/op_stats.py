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

These differ in kind from XLA's ``cost_analysis``: the FLOPs are the
products' only (XLA counts elementwise ops too), and the bytes are those
of an eager program with no fusion (XLA's fused program reads and writes
less).  So the port's records and the reference's are not compared with
each other.
"""
from __future__ import annotations

import sys
import weakref
from typing import Any, Dict

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

    def __init__(self, hold: Any = None):
        super().__init__()
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
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
