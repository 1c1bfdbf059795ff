"""AST lint engine — the port's invariants as pluggable visitors
(``repro/analysis/lint.py``).

Each rule is a ``Rule`` subclass registered with ``@register_rule``; the
engine parses every file once, computes the *traced-scope* map (which
function bodies run under a ``torch.func`` transform, ``torch.compile``,
activation checkpointing, a CUDA graph, an autograd ``Function`` or the
device round) and hands each rule a ``ModuleContext`` with the tree, the
scope map and dotted-name helpers.  Rules yield ``Finding``s;
pragma/baseline suppression happens downstream
(``findings.filter_findings``).

Traced-scope heuristic (shared by the host-sync rule and anyone else who
cares whether code runs where a host read stalls the card or is baked in
at capture time):

- a function (or lambda) passed by name to ``torch.func.vmap`` / ``grad``
  / ``grad_and_value`` / ``vjp`` / ``jvp`` / ``jacrev`` / ``jacfwd`` /
  ``functional_call`` / ``torch.utils.checkpoint.checkpoint`` /
  ``torch.compile`` / ``torch.cuda.make_graphed_callables`` is traced —
  as an argument or as a decorator (``@torch.compile``,
  ``@partial(torch.func.vmap, ...)``);
- the ``forward``, ``backward`` and ``setup_context`` of a class deriving
  from ``torch.autograd.Function`` are traced: autograd runs them inside
  the graph it records, and a host read there stalls every step;
- every function nested (at any depth) inside a ``build_*``/``make_*``
  builder is traced — the port's engines close round/epoch/step functions
  over builder arguments (``core/fused_round.build_device_round``'s
  ``round_fn``), so the builder *body* is host code but its nested defs
  are the device path;
- nesting inside a traced function is traced.

This is a heuristic, not an escape analysis: it is tuned to this repo's
idioms and errs toward silence (a function the engine cannot resolve is
host code).  The fixtures in ``tests/test_torch_analysis.py`` pin both
directions for every rule.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Type

from repro_torch.analysis.findings import Finding

# call names whose function-valued arguments end up traced
TRACING_CALL_NAMES = frozenset({
    "vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev", "jacfwd",
    "functional_call", "checkpoint", "compile", "make_graphed_callables",
})

# the methods autograd runs for a ``torch.autograd.Function`` subclass
AUTOGRAD_METHODS = frozenset({"forward", "backward", "setup_context"})
_AUTOGRAD_BASES = frozenset({"torch.autograd.Function", "autograd.Function",
                             "Function"})

BUILDER_RE = re.compile(r"^_{0,2}(build|make)_")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.func.vmap`` for the matching Attribute/Name chain, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleContext:
    """One parsed file + everything rules share (scopes, parents, lines)."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.traced: set = self._compute_traced()

    # -- scope machinery ----------------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                return cur
            cur = self.parents.get(cur)
        return None

    def in_traced_scope(self, node: ast.AST) -> bool:
        fn = self.enclosing_function(node)
        return fn is not None and id(fn) in self.traced

    def _compute_traced(self) -> set:
        by_name: Dict[Tuple[int, str], ast.AST] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                owner = self.enclosing_function(node)
                by_name[(id(owner), node.name)] = node

        traced: set = set()

        def resolve(arg: ast.AST, scope_fn) -> Optional[ast.AST]:
            # fn, functools.partial(fn, ...), or a lambda literal
            if isinstance(arg, ast.Lambda):
                return arg
            if isinstance(arg, ast.Call):
                d = dotted_name(arg.func)
                if d and d.split(".")[-1] == "partial" and arg.args:
                    return resolve(arg.args[0], scope_fn)
                return None
            if isinstance(arg, ast.Name):
                # look the name up through the enclosing function chain
                cur = scope_fn
                while True:
                    hit = by_name.get((id(cur), arg.id))
                    if hit is not None:
                        return hit
                    if cur is None:
                        return None
                    cur = self.enclosing_function(cur)
            return None

        def is_tracing_name(node: ast.AST) -> bool:
            d = dotted_name(node)
            return d is not None and d.split(".")[-1] in TRACING_CALL_NAMES

        # decorator forms: @torch.compile / @torch.compile(...) /
        # @partial(torch.func.vmap, ...)
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if is_tracing_name(target):
                    traced.add(id(node))
                elif isinstance(dec, ast.Call) and dec.args:
                    d = dotted_name(dec.func)
                    if d and d.split(".")[-1] == "partial" \
                            and is_tracing_name(dec.args[0]):
                        traced.add(id(node))

        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None or d.split(".")[-1] not in TRACING_CALL_NAMES:
                continue
            scope_fn = self.enclosing_function(node)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                target = resolve(arg, scope_fn)
                if target is not None:
                    traced.add(id(target))

        # torch.autograd.Function subclasses: what autograd runs
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef) and any(
                    dotted_name(b) in _AUTOGRAD_BASES for b in node.bases):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and item.name in AUTOGRAD_METHODS:
                        traced.add(id(item))

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and BUILDER_RE.match(node.name):
                for sub in ast.walk(node):
                    if sub is not node and isinstance(sub, _FUNC_NODES):
                        traced.add(id(sub))

        # closure: nesting inside a traced function is traced
        changed = True
        while changed:
            changed = False
            for node in ast.walk(self.tree):
                if isinstance(node, _FUNC_NODES) and id(node) in traced:
                    for sub in ast.walk(node):
                        if sub is not node and isinstance(sub, _FUNC_NODES) \
                                and id(sub) not in traced:
                            traced.add(id(sub))
                            changed = True
        return traced

    # -- finding helper ------------------------------------------------------

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = self.lines[line - 1].strip() if line <= len(self.lines) \
            else ""
        return Finding(self.relpath, line, col, rule, message, snippet)


class Rule:
    """One invariant.  ``applies`` gates by repo-relative path; ``check``
    yields findings for a parsed module."""
    name = "base"
    description = ""

    def applies(self, relpath: str) -> bool:
        raise NotImplementedError

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError


RULES: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    if cls.name in RULES:
        raise ValueError(f"lint rule {cls.name!r} already registered")
    RULES[cls.name] = cls
    return cls


def all_rules() -> List[Rule]:
    # rule modules self-register on import
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return [cls() for _, cls in sorted(RULES.items())]


def lint_source(source: str, relpath: str,
                rules: Optional[List[Rule]] = None) -> List[Finding]:
    """Lint one in-memory module (the test-fixture entry point)."""
    rules = rules if rules is not None else all_rules()
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(relpath, exc.lineno or 1, exc.offset or 0,
                        "syntax", f"could not parse: {exc.msg}")]
    ctx = ModuleContext(relpath, source, tree)
    out: List[Finding] = []
    for rule in rules:
        if rule.applies(relpath):
            out.extend(rule.check(ctx))
    return out


def iter_py_files(root: Path, paths: Iterable[str]) -> Iterator[Path]:
    for p in paths:
        full = root / p
        if full.is_file() and full.suffix == ".py":
            yield full
        elif full.is_dir():
            yield from sorted(f for f in full.rglob("*.py")
                              if "__pycache__" not in f.parts)


def lint_paths(root: Path, paths: Iterable[str],
               rules: Optional[List[Rule]] = None
               ) -> Tuple[List[Finding], Dict[str, List[str]]]:
    """Lint every .py under ``paths`` (relative to ``root``).

    Returns ``(findings, sources)`` with ``sources`` the per-file line
    lists the pragma filter needs."""
    rules = rules if rules is not None else all_rules()
    findings: List[Finding] = []
    sources: Dict[str, List[str]] = {}
    for f in iter_py_files(root, paths):
        rel = f.relative_to(root).as_posix()
        source = f.read_text()
        sources[rel] = source.splitlines()
        findings.extend(lint_source(source, rel, rules))
    return findings, sources
