"""scheme-branch: no scheme-string branching outside ``core/schemes.py``
(``repro/analysis/rules/scheme_strings.py``, on the port's tree).

Before the scheme registry, every engine branched on ``scheme ==
"opt"``-style strings and a new scheme meant editing all of them; the
registry (``repro_torch.core.schemes``, as ``repro.core.schemes`` in the
reference) is the single dispatch point.  This rule keeps it that way: any
comparison between a ``*scheme*``-named value and a string literal (or
literal collection) inside ``src/repro_torch`` is a finding.
Presentation code outside the package is out of scope — the invariant is
about engine logic, not labels.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import ModuleContext, Rule, register_rule

_EXEMPT = ("src/repro_torch/core/schemes.py", "src/repro_torch/analysis/")


def _mentions_scheme(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id.lower().endswith("scheme")
    if isinstance(node, ast.Attribute):
        return node.attr.lower().endswith("scheme")
    return False


def _is_str_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return bool(node.elts) and all(_is_str_literal(e)
                                       for e in node.elts)
    return False


@register_rule
class SchemeBranchRule(Rule):
    name = "scheme-branch"
    description = ("no scheme ==/in string branching outside "
                   "core/schemes.py — dispatch through the registry")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith("src/repro_torch/") \
            and not relpath.startswith(_EXEMPT[1]) \
            and relpath != _EXEMPT[0]

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not all(isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn))
                       for op in node.ops):
                continue
            operands = [node.left] + list(node.comparators)
            if any(_mentions_scheme(o) for o in operands) \
                    and any(_is_str_literal(o) for o in operands):
                yield ctx.finding(
                    node, self.name,
                    "scheme-string branch outside core/schemes.py; "
                    "dispatch through get_scheme(...)/a Scheme method")
