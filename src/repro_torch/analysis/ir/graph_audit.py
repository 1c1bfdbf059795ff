"""Aten-graph walker: liveness peak-memory estimate + bf16→f32 promotion
audit (``repro/analysis/ir/jaxpr_audit.py`` on ``make_fx`` graphs).

``trace_program`` runs one registry entry under
``torch.fx.experimental.proxy_tensor.make_fx`` in its real mode (CPU
tensors; see ``programs.py`` for why not fake ones) and returns the aten
graph; ``audit_program`` walks it:

- **provenance** — ``make_fx`` keeps source lines only for frames named
  ``forward``, so the trace runs under ``_SiteStamp``, a
  ``TorchDispatchMode`` above ``make_fx``'s own: every node an aten op
  adds to the graph is stamped with the innermost frame of the call
  under ``src/repro_torch/``, ``examples/`` or ``tests/`` (repo-relative
  ``path:line``; the tree helpers of ``utils/tree.py`` pass a buffer on
  to their caller's line, as the reference's jax-internal
  ``tree_map`` frames do).  A node with no such frame is ``<torch-internal>``;
  the program's inputs, and the constants the trace lifts (a draw from
  a ``torch.Generator`` runs outside it), are ``<argument>``.
- **liveness** — a linear scan over the nodes: a buffer is born at the
  node whose output is new storage and dies after the last node that
  reads it or any view of it (program outputs live to the end).  An
  aten graph, unlike a jaxpr, aliases: in-place ops (``add_``,
  ``copy_``, ``index_copy_``) and views (``view``, ``slice``,
  ``expand``, ``t``, ``unbind``) return storage they were given, which
  the op's schema says (``alias_info`` on a return); those allocate
  nothing and extend their base's life.  The running live total is a
  peak-memory estimate with *per-buffer provenance*: which op and which
  source line made each buffer.  ``make_fx`` inlines Python loops,
  ``torch.func.vmap`` and autograd into one flat graph, so their bodies
  are walked where they run; a higher-order op that keeps a subgraph
  (``torch.cond``, ``while_loop``) is walked by recursion, its peak less
  its inputs (views of outer buffers) counted as transient overhead at
  the call.  The estimate is what eager torch asks its allocator for
  with every buffer freed at its last use: it scales in K as the real
  program does.
- **dtype promotion** — inside a ``compute_dtype="bf16"`` program, an
  f32 tensor born from bf16 operands is a silent upcast.  aten has no
  implicit-convert op: ``mul`` of a bf16 and an f32 tensor returns f32
  directly, so *any* op minting f32 from bf16 operands is flagged, except
  a conversion (``_to_copy``, or ``copy_`` into an f32 buffer) whose
  source line shows the cast (``.to(``, ``.float(``, ``float32``, ...),
  which is deliberate and the AST ``dtype-thread`` rule's business.
  aten's products return their operands' dtype, so the reference's
  ``preferred_element_type`` accumulator exemption has no counterpart and
  nothing else is exempt.

Findings carry real ``path:line`` sites, so the CLI's pragma + baseline
machinery applies to them unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import operator
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.ir.programs import EngineProgram

TOP_N = 8            # live buffers reported at the peak program point
ANCHORS = ("src/repro_torch/", "examples/", "tests/")
# helpers that make buffers on their caller's behalf, as jax's tree_util
# does for the reference (whose frames ``user_frame`` skips): the buffer
# belongs to the caller's line
PASS_THROUGH = ("src/repro_torch/utils/tree.py",)
ARGUMENT = "<argument>"
INTERNAL = "<torch-internal>"
# conversions: the only ops a visible cast on their line exempts
_CONVERTS = frozenset({"_to_copy", "copy_", "convert_element_type"})
# source-line tokens that make an upcast *visible*
_CAST_MARKERS = (".to(", ".float(", "float32", "f32", ".type(", "promote")
_MAX_DEPTH = 12


@dataclasses.dataclass(frozen=True)
class BufferSite:
    """Where a buffer was born: repo-relative source line + aten op."""
    path: str
    line: int
    primitive: str

    def label(self) -> str:
        return f"{self.path}:{self.line} ({self.primitive})"


@dataclasses.dataclass
class BufferInfo:
    site: BufferSite
    nbytes: int
    shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass
class ProgramAudit:
    """One program's walk: the peak estimate and everything it's made of."""
    name: str
    peak_bytes: int
    peak_live: List[BufferInfo]              # live set at the peak point
    site_max_bytes: Dict[BufferSite, int]    # per-site max buffer bytes
    n_eqns: int                              # aten ops, subgraphs included

    def top_buffers(self, n: int = TOP_N) -> List[BufferInfo]:
        return sorted(self.peak_live, key=lambda b: -b.nbytes)[:n]


# ---------------------------------------------------------------------------
# tracing with provenance
# ---------------------------------------------------------------------------

def _repo_relative(filename: str) -> Optional[str]:
    """``/abs/.../src/repro_torch/x.py`` -> ``src/repro_torch/x.py``, or
    None outside the anchors."""
    norm = filename.replace("\\", "/")
    for anchor in ANCHORS:
        idx = norm.find(anchor)
        if idx >= 0:
            return norm[idx:]
    return None


def _user_site() -> Tuple[str, int]:
    """The innermost frame under an anchor, this module's and the
    pass-through helpers' excluded."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name != __file__:
            rel = _repo_relative(name)
            if rel is not None and rel not in PASS_THROUGH:
                return rel, f.f_lineno
        f = f.f_back
    return INTERNAL, 0


class _SiteStamp(TorchDispatchMode):
    """Stamps every graph node an op adds with the op's user frame."""

    # a higher-order op (``torch.cond``) passes through too: the nodes its
    # tracing adds, subgraphs included, take the call's frame
    supports_higher_order_operators = True

    def __init__(self, graph: torch.fx.Graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.fx.experimental.proxy_tensor import \
            disable_proxy_modes_tracing
        kwargs = kwargs or {}
        if kwargs.get("generator") is not None:
            # a draw from a generator runs outside the trace (not every
            # release's make_fx records a generator): its tensor enters
            # the graph as a constant
            with disable_proxy_modes_tracing():
                return func(*args, **kwargs)
        site = _user_site()
        last = next(iter(reversed(self.graph.nodes)), None)
        out = func(*args, **kwargs)
        node = last.next if last is not None else \
            next(iter(self.graph.nodes), None)
        while node is not None and node.op != "root":
            node.meta.setdefault("ir_site", site)
            node = node.next
        return out


def trace_program(prog: EngineProgram, k: int) -> torch.fx.GraphModule:
    """The program's aten graph at user count K, every node stamped."""
    fn, args = prog.build(k)
    return trace_fn(fn, args)


def trace_fn(fn, args) -> torch.fx.GraphModule:
    """``fn(*args)``'s aten graph, every node stamped with its site."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

    def stamped(*a):
        with _SiteStamp(get_proxy_mode().tracer.graph):
            return fn(*a)

    # real mode: the kernel wrappers run their CPU twins, and a value read
    # back to the host (a one_hot's class check) is read, not refused.
    # The tracing context lends make_fx one fake mode for the nodes'
    # metadata, where it would make a new one for every op (40% of a
    # trace's time); the torch-function metadata no walk reads is not
    # recorded where the release lets it be skipped (17% more)
    kw = {"_disable_torch_fn_metadata_mode": True} \
        if "_disable_torch_fn_metadata_mode" in \
        inspect.signature(make_fx).parameters else {}
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        return make_fx(stamped, tracing_mode="real",
                       _error_on_data_dependent_ops=False, **kw)(*args)


# ---------------------------------------------------------------------------
# the liveness walk
# ---------------------------------------------------------------------------

def _primitive(node: torch.fx.Node) -> str:
    target = node.target
    packet = getattr(target, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _site(node: torch.fx.Node,
          inherit: Tuple[str, int] = (INTERNAL, 0)) -> BufferSite:
    """A node's site; a subgraph's nodes, which the stamp does not reach,
    take the site of the op that runs them (``inherit``)."""
    if node.op in ("placeholder", "get_attr"):
        return BufferSite(ARGUMENT, 0, "argument")
    path, line = node.meta.get("ir_site", inherit)
    return BufferSite(path, line, _primitive(node))


def _info(t: Any, site: BufferSite) -> BufferInfo:
    return BufferInfo(site, int(t.untyped_storage().nbytes()),
                      tuple(t.shape), str(t.dtype).removeprefix("torch."))


def _input_nodes(node: torch.fx.Node) -> List[torch.fx.Node]:
    leaves, _ = tree_flatten((node.args, node.kwargs))
    return [a for a in leaves if isinstance(a, torch.fx.Node)]


def _refs(out: Any) -> List[int]:
    """Buffer ids an output structure references."""
    leaves, _ = tree_flatten(out)
    return [b for b in leaves if isinstance(b, int)]


def _aliased_arg(node: torch.fx.Node, ret) -> Optional[Any]:
    """The argument a schema return aliases (``Tensor(a)`` / ``(a!)``)."""
    sets = set(ret.alias_info.before_set) if ret.alias_info else set()
    if not sets:
        return None
    schema = node.target._schema
    for j, arg in enumerate(schema.arguments):
        if arg.alias_info and sets & set(arg.alias_info.before_set):
            if j < len(node.args):
                return node.args[j]
            return node.kwargs.get(arg.name)
    return None


class _Walk:
    """Buffers of one graph: ids, sizes and sites, outputs by node."""

    def __init__(self, site_max: Dict[BufferSite, int],
                 inherit: Tuple[str, int], inner: bool):
        self.info: Dict[int, BufferInfo] = {}
        self.site_max = site_max
        self.inherit = inherit
        self.inner = inner      # a subgraph: its inputs are outer buffers

    def new(self, t: torch.Tensor, site: BufferSite) -> int:
        b = len(self.info)
        self.info[b] = _info(t, site)
        if not (self.inner and site.path == ARGUMENT) and \
                self.info[b].nbytes > self.site_max.get(site, 0):
            self.site_max[site] = self.info[b].nbytes
        return b

    def fresh(self, val: Any, site: BufferSite) -> Any:
        """New buffers for every tensor of ``val``, as its structure."""
        if isinstance(val, torch.Tensor):
            return self.new(val, site)
        if isinstance(val, (list, tuple)):
            return [self.fresh(v, site) for v in val]
        return None


def _outputs(node: torch.fx.Node, w: _Walk, outs: Dict) -> Any:
    val = node.meta.get("val")
    site = _site(node, w.inherit)
    if node.op in ("placeholder", "get_attr"):
        return w.fresh(val, site)
    if node.target is operator.getitem:
        parent, idx = node.args
        got = outs.get(parent)
        return got[idx] if isinstance(got, list) else got
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return w.fresh(val, site)
    rets = schema.returns
    vals = [val] if len(rets) == 1 else list(val or ())
    result = []
    for ret, v in zip(rets, vals):
        src = _aliased_arg(node, ret)
        if src is not None:
            base = outs.get(src) if isinstance(src, torch.fx.Node) else None
            if isinstance(v, (list, tuple)):
                base = (base if isinstance(base, int)
                        else (_refs(base) or [None])[0])
                result.append([base] * len(v))
            else:
                result.append(base if not isinstance(base, list)
                              else (_refs(base) or [None])[0])
        else:
            result.append(w.fresh(v, site))
    return result[0] if len(rets) == 1 else result


def _subgraphs(gm: torch.fx.GraphModule,
               node: torch.fx.Node) -> List[torch.fx.GraphModule]:
    """Subgraphs a higher-order op runs (``torch.cond``, ``while_loop``)."""
    out = []
    for a in _input_nodes(node):
        if a.op == "get_attr":
            sub = getattr(gm, a.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                out.append(sub)
    return out


def _walk(gm: torch.fx.GraphModule, site_max: Dict[BufferSite, int],
          depth: int = 0, inherit: Tuple[str, int] = (INTERNAL, 0)
          ) -> Tuple[int, List[BufferInfo], int, int]:
    """Linear-scan liveness over one graph.

    Returns ``(peak_bytes, live_set_at_peak, input_bytes, n_ops)``;
    ``site_max`` accumulates the largest single buffer each source site
    ever created (recursively: the scaling gate fits per-site exponents
    from it)."""
    nodes = list(gm.graph.nodes)
    w = _Walk(site_max, inherit, depth > 0)
    outs: Dict[torch.fx.Node, Any] = {}
    born: List[List[int]] = []
    for node in nodes:
        before = len(w.info)
        if node.op != "output":
            outs[node] = _outputs(node, w, outs)
        born.append(list(range(before, len(w.info))))
    last_use: Dict[int, int] = {b: i for i, bs in enumerate(born)
                                for b in bs}
    for i, node in enumerate(nodes):
        for a in _input_nodes(node):
            for b in _refs(outs.get(a)):
                last_use[b] = len(nodes) if node.op == "output" else i
    free_at: Dict[int, List[int]] = {}
    for b, i in last_use.items():
        free_at.setdefault(i, []).append(b)

    live: Dict[int, BufferInfo] = {}
    cur = peak = in_bytes = n_ops = 0
    peak_live: List[BufferInfo] = []
    for i, node in enumerate(nodes):
        for b in born[i]:
            live[b] = w.info[b]
            cur += w.info[b].nbytes
            if node.op == "placeholder":
                in_bytes += w.info[b].nbytes
        inner_extra, inner_live = 0, []
        if node.op == "call_function":
            n_ops += 1
            if depth < _MAX_DEPTH:
                call = _site(node, inherit)
                for sub in _subgraphs(gm, node):
                    s_peak, s_live, s_in, s_ops = _walk(
                        sub, site_max, depth + 1, (call.path, call.line))
                    n_ops += s_ops
                    extra = max(0, s_peak - s_in)
                    if extra > inner_extra:
                        inner_extra = extra
                        inner_live = [b for b in s_live if b.nbytes > 0
                                      and b.site.path != ARGUMENT]
        if cur + inner_extra > peak:
            peak = cur + inner_extra
            peak_live = list(live.values()) + inner_live
        for b in free_at.get(i, ()):
            if b in live:
                cur -= live.pop(b).nbytes
    return peak, peak_live, in_bytes, n_ops


def audit_graph(name: str, gm: torch.fx.GraphModule) -> ProgramAudit:
    """Walk one traced graph."""
    site_max: Dict[BufferSite, int] = {}
    peak, peak_live, _, n_ops = _walk(gm, site_max)
    return ProgramAudit(name=name, peak_bytes=peak, peak_live=peak_live,
                        site_max_bytes=site_max, n_eqns=n_ops)


def audit_program(prog: EngineProgram, k: int = 4,
                  gm: Optional[torch.fx.GraphModule] = None) -> ProgramAudit:
    """Trace (or reuse ``gm``) and walk one program at user count K."""
    return audit_graph(prog.name, gm if gm is not None
                       else trace_program(prog, k))


# ---------------------------------------------------------------------------
# dtype-promotion audit (bf16 programs only)
# ---------------------------------------------------------------------------

def _iter_nodes(gm: torch.fx.GraphModule, depth: int = 0,
                inherit: Tuple[str, int] = (INTERNAL, 0)
                ) -> Iterable[Tuple[torch.fx.Node, Tuple[str, int]]]:
    """Every node, subgraphs' included, with the site it inherits."""
    for node in gm.graph.nodes:
        yield node, inherit
        if node.op == "call_function" and depth < _MAX_DEPTH:
            call = _site(node, inherit)
            for sub in _subgraphs(gm, node):
                yield from _iter_nodes(sub, depth + 1, (call.path, call.line))


def _float_dtypes(vals: Iterable[Any]) -> set:
    return {v.dtype for v in vals
            if isinstance(v, torch.Tensor) and v.dtype.is_floating_point}


def _repo_root() -> Path:
    # src/repro_torch/analysis/ir/graph_audit.py -> four levels up
    return Path(__file__).resolve().parents[4]


@functools.lru_cache(maxsize=4096)
def _source_line(path: str, line: int) -> Optional[str]:
    try:
        lines = (_repo_root() / path).read_text().splitlines()
        return lines[line - 1] if 1 <= line <= len(lines) else None
    except OSError:
        return None


def _visible_cast(site: BufferSite) -> bool:
    """True when the offending source line shows the cast itself.

    Unreadable sites (torch internals) count as visible: the audit only
    claims *silent* when it can read the line and see nothing."""
    text = _source_line(site.path, site.line)
    if text is None:
        return True
    low = text.lower()
    return any(m in low for m in _CAST_MARKERS)


def dtype_promotions(prog: EngineProgram,
                     gm: Optional[torch.fx.GraphModule] = None,
                     k: int = 4) -> List[Finding]:
    """f32 tensors born from bf16 operands inside a bf16-policy program."""
    if prog.compute_dtype != "bf16":
        return []
    if gm is None:
        gm = trace_program(prog, k)
    findings: List[Finding] = []
    seen = set()
    for node, inherit in _iter_nodes(gm):
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        ins = [a.meta.get("val") for a in _input_nodes(node)]
        if torch.bfloat16 not in _float_dtypes(ins):
            continue
        outs, _ = tree_flatten(node.meta.get("val"))
        f32 = [v for v in outs if isinstance(v, torch.Tensor)
               and v.dtype == torch.float32]
        if not f32:
            continue
        site = _site(node, inherit)
        convert = site.primitive in _CONVERTS
        if convert and _visible_cast(site):
            continue           # deliberate cast: dtype-thread's business
        key = (site.path, site.line, site.primitive)
        if key in seen:
            continue
        seen.add(key)
        how = (f"{site.primitive} converts bf16 to f32 with no cast on "
               f"its line" if convert
               else f"{site.primitive} mints f32 from bf16 operands "
                    f"(implicit promotion)")
        findings.append(Finding(
            site.path, site.line or 1, 0, "ir-dtype",
            f"{prog.name}: {how} -> f32{list(f32[0].shape)} inside a "
            f"compute_dtype=bf16 program — a silent upcast; cast "
            f"explicitly (a visible .to(...)/float32 on the line is "
            f"exempt) or keep the op in bf16"))
    return findings


def run_graph_audit(programs=None, k: int = 4
                    ) -> Tuple[List[Finding], List[ProgramAudit]]:
    """Walk every registry program once: dtype findings + memory audits.

    A program that fails to trace is itself a finding (same convention as
    the contract sweep)."""
    from repro_torch.analysis.ir.programs import engine_programs
    findings: List[Finding] = []
    audits: List[ProgramAudit] = []
    for prog in (programs if programs is not None else engine_programs()):
        try:
            gm = trace_program(prog, k)
        except Exception as exc:      # a broken trace IS the finding
            findings.append(Finding(
                prog.path, 1, 0, "ir-trace",
                f"{prog.name}: make_fx trace failed at K={k}: "
                f"{type(exc).__name__}: {exc}"))
            continue
        audits.append(audit_program(prog, k, gm=gm))
        findings.extend(dtype_promotions(prog, gm=gm, k=k))
    return findings, audits
