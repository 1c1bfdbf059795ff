"""rng-reuse: every random draw comes from a stream of its own
(``repro/analysis/rules/rng_discipline.py``, in torch's form).

JAX's rule is "a PRNG key is consumed at most once per path": feeding one
key to two draws silently correlates them (fading and outage streams that
move in lockstep skew the eq. 1-7 channel statistics without failing any
shape check).  torch has no keys: a draw takes from a ``torch.Generator``,
or from the global generator every caller shares.  The same two defect
classes take this form:

(a) a random draw with no ``generator=``: ``torch.rand``/``randn``/
    ``randint``/``randperm``/``normal``/``bernoulli``/``multinomial``/
    ``poisson``, ``Tensor.uniform_``/``normal_``/``bernoulli_``/
    ``random_``/``exponential_``, or a random ``torch.nn.init`` fill.  It
    takes from the global stream, so its numbers depend on every other
    draw the process made before it (the port's engines draw from
    ``core/streams.py``'s per-simulation generators);
(b) a generator re-seeded by ``manual_seed`` with the same seed name twice
    on one path, or inside a loop with the seed bound outside it: the
    same stream replayed, the torch form of one key consumed twice.

(b) reuses the reference's per-function, statement-ordered walk
(``_Walker``): ``manual_seed(<name>)`` **consumes** the seed name;
rebinding a name resets it; branches of an ``if`` are analyzed
independently (two exclusive arms may each seed from the same name); a
seed consumed inside a loop whose binding lives outside the loop is a
reuse.  Only first-argument *names* are tracked — composite expressions
like ``manual_seed(seed + i)`` derive a fresh stream by construction.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import ModuleContext, Rule, dotted_name, \
    register_rule

# torch.<fn>(...) draws that take a ``generator=``
TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm", "normal",
                         "bernoulli", "multinomial", "poisson"})
# in-place Tensor draws that take a ``generator=``
TENSOR_DRAWS = frozenset({"uniform_", "normal_", "bernoulli_", "random_",
                          "exponential_"})
# the random fills of torch.nn.init
INIT_DRAWS = frozenset({"uniform_", "normal_", "trunc_normal_",
                        "xavier_uniform_", "xavier_normal_",
                        "kaiming_uniform_", "kaiming_normal_",
                        "orthogonal_", "sparse_"})
_INIT_BASES = ("torch.nn.init", "nn.init", "init")


def _unseeded_draw(call: ast.Call) -> Optional[str]:
    """The printable draw if ``call`` is a random draw without a
    ``generator=``."""
    if any(kw.arg == "generator" for kw in call.keywords):
        return None
    d = dotted_name(call.func)
    if d is not None:
        base, _, fn = d.rpartition(".")
        if base == "torch" and fn in TORCH_DRAWS:
            return d
        if base in _INIT_BASES and fn in INIT_DRAWS:
            return d
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in TENSOR_DRAWS \
            and (d is None or d.rpartition(".")[0] not in _INIT_BASES):
        return f"Tensor.{call.func.attr}"
    return None


def _consuming_key(call: ast.Call) -> Optional[str]:
    """Name of the seed consumed by ``call`` (``<gen>.manual_seed(name)``),
    if any."""
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "manual_seed" \
            and call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


class _Walker:
    """Statement-ordered abstract walk of one function body."""

    def __init__(self, ctx: ModuleContext, rule: str):
        self.ctx = ctx
        self.rule = rule
        self.findings: List[Finding] = []

    def run(self, body) -> None:
        self._block(body, bindings={}, consumed={}, depth=0)

    # state: bindings name->loop depth of binding; consumed name->node
    def _block(self, stmts, bindings: Dict[str, int],
               consumed: Dict[str, ast.AST], depth: int) -> None:
        for stmt in stmts:
            self._stmt(stmt, bindings, consumed, depth)

    def _stmt(self, stmt, bindings, consumed, depth) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = stmt.args
            params = {p.arg: 0 for p in (a.posonlyargs + a.args
                                         + a.kwonlyargs)}
            self._block(stmt.body, params, {}, 0)
            return
        if isinstance(stmt, ast.ClassDef):
            self._block(stmt.body, {}, {}, 0)
            return
        if isinstance(stmt, (ast.If,)):
            self._exprs(stmt.test, bindings, consumed, depth)
            b1, c1 = dict(bindings), dict(consumed)
            b2, c2 = dict(bindings), dict(consumed)
            self._block(stmt.body, b1, c1, depth)
            self._block(stmt.orelse, b2, c2, depth)
            consumed.clear()
            consumed.update(c1)
            consumed.update(c2)
            bindings.update(b1)
            bindings.update(b2)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exprs(stmt.iter, bindings, consumed, depth)
            self._bind_target(stmt.target, bindings, consumed, depth + 1)
            self._block(stmt.body, bindings, consumed, depth + 1)
            self._block(stmt.orelse, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.While):
            self._exprs(stmt.test, bindings, consumed, depth + 1)
            self._block(stmt.body, bindings, consumed, depth + 1)
            self._block(stmt.orelse, bindings, consumed, depth)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._exprs(item.context_expr, bindings, consumed, depth)
            self._block(stmt.body, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, bindings, consumed, depth)
            for h in stmt.handlers:
                self._block(h.body, dict(bindings), dict(consumed), depth)
            self._block(stmt.orelse, bindings, consumed, depth)
            self._block(stmt.finalbody, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.Assign):
            # `seed = seed + 1; g.manual_seed(seed)`-style chaining: the
            # statement rebinds the name it consumes — exempt from the
            # loop-reuse check
            rebound = set()
            for t in stmt.targets:
                self._target_names(t, rebound)
            self._exprs(stmt.value, bindings, consumed, depth,
                        rebinding=rebound)
            for t in stmt.targets:
                self._bind_target(t, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.AugAssign):
            self._exprs(stmt.value, bindings, consumed, depth)
            self._bind_target(stmt.target, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._exprs(stmt.value, bindings, consumed, depth)
            self._bind_target(stmt.target, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            self._exprs(stmt.value, bindings, consumed, depth)
            return
        if isinstance(stmt, ast.Expr):
            self._exprs(stmt.value, bindings, consumed, depth)
            return
        # anything else: scan its expressions conservatively
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._exprs(child, bindings, consumed, depth)

    def _target_names(self, target, out: set) -> None:
        if isinstance(target, ast.Name):
            out.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._target_names(el, out)
        elif isinstance(target, ast.Starred):
            self._target_names(target.value, out)

    def _bind_target(self, target, bindings, consumed, depth) -> None:
        if isinstance(target, ast.Name):
            bindings[target.id] = depth
            consumed.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, bindings, consumed, depth)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, bindings, consumed, depth)

    def _exprs(self, expr, bindings, consumed, depth,
               rebinding: set = frozenset()) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda, ast.ListComp, ast.SetComp,
                                 ast.DictComp, ast.GeneratorExp)):
                continue  # handled below / out of scope for the linear walk
            if not isinstance(node, ast.Call):
                continue
            key = _consuming_key(node)
            if key is None:
                continue
            if key in consumed:
                self.findings.append(self.ctx.finding(
                    node, self.rule,
                    f"seed {key!r} already seeded a generator at line "
                    f"{consumed[key].lineno}: the same stream replayed; "
                    f"derive a distinct seed or keep drawing from the "
                    f"first generator"))
            elif key in bindings and bindings[key] < depth \
                    and key not in rebinding:
                self.findings.append(self.ctx.finding(
                    node, self.rule,
                    f"seed {key!r} bound outside this loop re-seeds a "
                    f"generator every iteration (the same stream each "
                    f"time); derive a per-iteration seed"))
            else:
                consumed[key] = node


@register_rule
class RngReuseRule(Rule):
    name = "rng-reuse"
    description = ("every random draw takes a generator=, and no seed "
                   "re-seeds a generator twice (or every loop iteration)")

    def applies(self, relpath: str) -> bool:
        return not relpath.startswith("src/repro_torch/analysis/")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                draw = _unseeded_draw(node)
                if draw is not None:
                    yield ctx.finding(
                        node, self.name,
                        f"{draw}() without generator= draws from the "
                        f"global stream every caller shares; pass the "
                        f"caller's torch.Generator")
        w = _Walker(ctx, self.name)
        w.run(ctx.tree.body)
        yield from w.findings
