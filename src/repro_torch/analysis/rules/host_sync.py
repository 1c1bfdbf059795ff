"""host-sync: no host-synchronizing calls inside traced code
(``repro/analysis/rules/host_sync.py``, in torch's idioms).

The device round and the sweep engine exist to keep the host off the
card's path: the round enqueues its kernels and reads nothing back.  One
stray ``.item()``/``float()``/``np.*`` on a device tensor makes the host
wait for the card every step, breaks a CUDA-graph capture and fails under
``torch.func`` transforms.  Inside traced scopes (see
``lint.ModuleContext``) in ``core/`` and ``kernels/`` this rule flags:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")``, and ``.synchronize()`` (``torch.cuda.synchronize()``);
- the ops whose output shape depends on the data, which read a size back
  from the card: ``nonzero``, ``masked_select``, ``unique`` and
  ``torch.where`` with one argument;
- any ``np.*`` call (host numpy cannot consume a device tensor);
- ``time.time()``-family clocks: inside the round a clock measures the
  host's enqueue, not the card's work, and under a transform or a CUDA
  graph it is a capture-time constant;
- ``float()/int()/bool()`` on non-static values (shape/ndim/``len``,
  ``.size()``/``.numel()``/``.dim()`` and literals are host values and
  stay legal).
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import ModuleContext, Rule, dotted_name, \
    register_rule

_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
_DYNAMIC_SHAPE = frozenset({"nonzero", "masked_select", "unique"})
_CLOCKS = frozenset({"time.time", "time.perf_counter", "time.monotonic",
                     "time.process_time"})
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device"})
_STATIC_METHODS = frozenset({"size", "numel", "dim"})


def _is_static(expr: ast.AST) -> bool:
    """Conservatively: is ``expr`` a host value (no read of the card)?"""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Attribute):
        return expr.attr in _STATIC_ATTRS or _is_static(expr.value)
    if isinstance(expr, ast.Subscript):
        return _is_static(expr.value)
    if isinstance(expr, ast.BinOp):
        return _is_static(expr.left) and _is_static(expr.right)
    if isinstance(expr, ast.UnaryOp):
        return _is_static(expr.operand)
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _STATIC_METHODS:
            return True
        d = dotted_name(expr.func)
        if d == "len":
            return True
        if d in ("int", "float", "bool"):
            return all(_is_static(a) for a in expr.args)
        return False
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")``."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and isinstance(a.value, str)
               and a.value.split(":")[0] == "cpu" for a in args)


@register_rule
class HostSyncRule(Rule):
    name = "host-sync"
    description = ("no .item()/.cpu()/float()/np.*/time.time()/nonzero on "
                   "device values inside traced bodies in core/ and "
                   "kernels/")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(("src/repro_torch/core/",
                                   "src/repro_torch/kernels/"))

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or not ctx.in_traced_scope(node):
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _SYNC_METHODS or (attr == "to" and _to_cpu(node)):
                    what = ".to('cpu')" if attr == "to" else f".{attr}()"
                    yield ctx.finding(
                        node, self.name,
                        f"{what} forces a host sync inside a traced body")
                    continue
                if attr in _DYNAMIC_SHAPE or (
                        attr == "where" and len(node.args) == 1
                        and not node.keywords):
                    yield ctx.finding(
                        node, self.name,
                        f"{attr}() has a data-dependent output shape: the "
                        f"host waits for the card to read its size inside "
                        f"a traced body")
                    continue
            d = dotted_name(node.func)
            if d is None:
                continue
            if d.startswith("np.") or d.startswith("numpy."):
                yield ctx.finding(
                    node, self.name,
                    f"host numpy call {d}() inside a traced body "
                    f"(use torch)")
            elif d in _CLOCKS:
                yield ctx.finding(
                    node, self.name,
                    f"{d}() in a traced body times the host's enqueue, not "
                    f"the card, and is a capture-time constant under a "
                    f"transform or a CUDA graph")
            elif d in ("float", "int", "bool") and node.args \
                    and not _is_static(node.args[0]):
                yield ctx.finding(
                    node, self.name,
                    f"{d}() on a possibly-device value inside a traced "
                    f"body (hoist to the builder, or keep it a tensor)")
