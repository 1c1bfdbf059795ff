"""except-swallow: retry paths may not silently eat broad exceptions
(``repro/analysis/rules/except_swallow.py``, on the port's tree).

The serving and transport layers are built on deliberate fault injection —
dropped chunks, timed-out uploads, crashed rounds — and their correctness
story is that every fault is either retried, logged, or surfaced.  A
``except Exception: pass`` (or ``continue``) in those paths converts an
injected fault into silent data loss: the aggregation round proceeds with
a missing update and the test suite can't tell.  Any handler for bare
``Exception``/``BaseException`` (or an untyped ``except:``) whose entire
body is ``pass``/``continue`` under ``serving/``, ``core/transport.py`` or
``core/faults.py`` is a finding.  Deliberate swallow sites (e.g.
best-effort cleanup) are annotated inline with
``# analysis: ok=except-swallow``.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import ModuleContext, Rule, dotted_name, \
    register_rule

_BROAD = ("Exception", "BaseException")
_SCOPE_PREFIXES = ("src/repro_torch/serving/",)
_SCOPE_FILES = ("src/repro_torch/core/transport.py",
                "src/repro_torch/core/faults.py")


def _is_broad(type_node) -> bool:
    if type_node is None:            # untyped `except:`
        return True
    d = dotted_name(type_node)
    return d is not None and d.split(".")[-1] in _BROAD


@register_rule
class ExceptSwallowRule(Rule):
    name = "except-swallow"
    description = ("'except Exception: pass/continue' in serving/transport "
                   "retry paths swallows injected faults")

    def applies(self, relpath: str) -> bool:
        return (relpath in _SCOPE_FILES
                or any(relpath.startswith(p) for p in _SCOPE_PREFIXES))

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node.type):
                continue
            if len(node.body) == 1 and \
                    isinstance(node.body[0], (ast.Pass, ast.Continue)):
                kind = ("pass" if isinstance(node.body[0], ast.Pass)
                        else "continue")
                caught = (dotted_name(node.type)
                          if node.type is not None else "everything")
                yield ctx.finding(
                    node, self.name,
                    f"handler catches {caught} and only does '{kind}' — "
                    f"in a fault-injected retry path this turns faults "
                    f"into silent data loss; re-raise, log, or record the "
                    f"failure ('# analysis: ok=except-swallow' for "
                    f"deliberate best-effort sites)")
