"""dtype-thread: dtype-policy parameters must be threaded, not shadowed
(``repro/analysis/rules/dtype_policy.py``, in torch's idioms).

The ``ForwardPolicy.precision`` plumbing works only if every function
that *accepts* a compute-dtype parameter actually honors it — a kernel
wrapper that takes ``compute_dtype`` and then hard-codes
``.to(torch.float32)`` silently pins the path to f32 and the bf16 rows
measure nothing.  For functions in ``kernels/`` and ``models/`` declaring
a dtype-like parameter (``compute_dtype``/``dtype``/``out_dtype``/...),
this rule flags

- a parameter the body never references, and
- a cast to a hard-coded float dtype: ``.to(torch.float32 | bfloat16 |
  float16)`` (positional or ``dtype=``), ``.type(...)``,
  ``.astype(np.float32)``, and the bare ``.float()``, ``.half()`` and
  ``.bfloat16()`` — deliberate f32-accumulation contracts are allowlisted
  inline where they occur (the pragma doubles as documentation).
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import ModuleContext, Rule, dotted_name, \
    register_rule

DTYPE_PARAMS = frozenset({"compute_dtype", "dtype", "out_dtype",
                          "param_dtype", "acc_dtype"})
_HARD_DTYPES = frozenset({"torch.float32", "torch.float", "torch.bfloat16",
                          "torch.float16", "torch.half", "np.float32"})
# the tensor methods that cast to one fixed float dtype
_CAST_METHODS = frozenset({"float", "half", "bfloat16"})


def _hard_cast(call: ast.Call) -> Optional[str]:
    """The printable cast if ``call`` casts to a hard-coded dtype."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _CAST_METHODS and not call.args and not call.keywords:
        return f".{attr}()"
    if attr in ("to", "type", "astype"):
        for arg in list(call.args) + [kw.value for kw in call.keywords
                                      if kw.arg in ("dtype", None)]:
            d = dotted_name(arg)
            if d in _HARD_DTYPES:
                return f".{attr}({d})"
    return None


@register_rule
class DtypeThreadRule(Rule):
    name = "dtype-thread"
    description = ("functions taking a compute_dtype/dtype policy must "
                   "thread it instead of hard-coding torch.float32")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(("src/repro_torch/kernels/",
                                   "src/repro_torch/models/"))

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = fn.args
            names = [a.arg for a in (args.posonlyargs + args.args
                                     + args.kwonlyargs)]
            dtype_args = [n for n in names if n in DTYPE_PARAMS]
            if not dtype_args:
                continue
            used = {n.id for sub in fn.body for n in ast.walk(sub)
                    if isinstance(n, ast.Name)}
            for missing in (a for a in dtype_args if a not in used):
                yield ctx.finding(
                    fn, self.name,
                    f"dtype parameter {missing!r} of {fn.name}() is never "
                    f"threaded into the body")
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                cast = _hard_cast(sub)
                if cast is not None:
                    yield ctx.finding(
                        sub, self.name,
                        f"{fn.name}() takes {dtype_args[0]!r} but "
                        f"hard-codes {cast}; thread the policy dtype "
                        f"(pragma if this is a deliberate accumulation "
                        f"contract)")
