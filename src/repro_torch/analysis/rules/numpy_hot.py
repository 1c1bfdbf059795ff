"""np-hot: no host numpy in the device-resident hot modules
(``repro/analysis/rules/numpy_hot.py``, on the port's tree).

The fused round, the schemes' device methods, the fleet channel, the
opportunistic sync, the transmission model and every kernel package are
device code end to end: a ``np.`` call there computes on the host and
forces a copy to or from the card.  Host *constants* (``np.pi``, dtype
objects) are fine; everything else in the hot-module list below must be
``torch``.  Host orchestration modules (``sweep.py``'s group set-up,
``selection.py``'s host schedule, ``hsfl.py``'s host engine) legitimately
use numpy and are not listed.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import ModuleContext, Rule, register_rule

HOT_MODULES = (
    "src/repro_torch/core/fused_round.py",
    "src/repro_torch/core/schemes.py",
    "src/repro_torch/core/channel_lib.py",
    "src/repro_torch/core/opportunistic_sync.py",
    "src/repro_torch/core/transmission.py",
    "src/repro_torch/kernels/",
)

# host constants and dtype objects are trace-time values, not host compute
ALLOWED_ATTRS = frozenset({
    "pi", "e", "inf", "nan", "euler_gamma", "newaxis",
    "float32", "float64", "float16", "int32", "int64", "int16", "int8",
    "uint8", "uint32", "bool_", "ndarray", "dtype", "generic",
})


@register_rule
class NumpyHotRule(Rule):
    name = "np-hot"
    description = ("no np.* (beyond constants/dtypes) in core//kernels/ "
                   "hot modules — device code is torch end to end")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(HOT_MODULES)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Attribute):
                continue
            if not isinstance(node.value, ast.Name) \
                    or node.value.id not in ("np", "numpy"):
                continue
            if node.attr in ALLOWED_ATTRS:
                continue
            # np.random.<x> chains surface as Attribute(np, 'random')
            yield ctx.finding(
                node, self.name,
                f"host numpy ({node.value.id}.{node.attr}) in a hot "
                f"module; use torch (np constants/dtypes are exempt)")
