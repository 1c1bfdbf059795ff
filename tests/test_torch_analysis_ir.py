"""The port's IR auditors (``repro_torch.analysis.ir``): registry, aten-
graph walker, bf16 promotion audit, K-scaling gate and the CLI's ``--ir``.

They mirror the reference's IR tests that pass in tier-1
(``tests/test_analysis_ir.py``); its three that fail there
(``test_walker_peak_covers_known_buffer``,
``test_implicit_bf16_promotion_fires``,
``test_gate_flags_undeclared_quadratic_buffer``) are no oracle, so their
intent is held by the port's own fixtures below: a known K x K gram
buffer, an implicit bf16 -> f32 promotion and an undeclared quadratic
buffer, each with its ``path:line`` in this file.  The reference's
committed ``analysis_scaling.json`` is read (never written) to hold each
program's total-peak exponent to XLA's.  The reference's donation tests
have no counterpart: the port donates nothing.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.ir import graph_audit, scaling  # noqa: E402
from repro_torch.analysis.ir.programs import (  # noqa: E402
    EngineProgram, covered_kernel_twins, covered_schemes, engine_programs,
    program_names)

REPO = Path(__file__).resolve().parents[1]
HERE = "tests/test_torch_analysis_ir.py"
LINES = (REPO / HERE).read_text().splitlines()


def _randn(*shape, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=gen).to(dtype)


def _line_of(text: str) -> int:
    """The line of this file that holds ``text`` (once)."""
    hits = [i + 1 for i, ln in enumerate(LINES)
            if text in ln and "_line_of" not in ln]
    assert len(hits) == 1, (text, hits)
    return hits[0]


# ---------------------------------------------------------------------------
# fixture programs
# ---------------------------------------------------------------------------

def _gram(x):
    g = x @ x.T            # GRAM: a K x K matrix on the user axis
    return g.sum()


def quadratic_prog():
    """Undeclared O(K^2) buffer on the user axis."""
    return EngineProgram(name="fixture[gram]", family="fixture", path=HERE,
                         build=lambda k: (_gram, (_randn(k, 8),)))


def _rowsum(x):
    y = x * 2.0
    return y.sum(dim=1)


def linear_prog():
    return EngineProgram(name="fixture[rowsum]", family="fixture",
                         path=HERE,
                         build=lambda k: (_rowsum, (_randn(k, 8),)))


def _leaky(x, s):
    return x * s           # LEAK: bf16 times f32 is f32


def _explicit(x, s):
    return x.to(torch.float32) * s


def _bf16_prog(fn, name, compute_dtype="bf16"):
    return EngineProgram(
        name=name, family="kernel", path=HERE,
        build=lambda k: (fn, (_randn(k, 8, dtype=torch.bfloat16),
                              _randn(8))),
        compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# registry coverage: every scheme, both builders; every kernel twin
# ---------------------------------------------------------------------------

def test_registry_covers_every_registered_scheme():
    from repro_torch.core.schemes import registered_schemes
    cov = covered_schemes()
    assert not set(registered_schemes()) - cov["fused_round"]
    assert not set(registered_schemes()) - cov["device_round"]


def test_registry_covers_every_kernel_twin():
    from repro_torch.analysis.contracts import kernel_twin_packages
    on_disk = kernel_twin_packages(REPO)
    assert on_disk, "expected kernel twin packages on disk"
    assert on_disk <= covered_kernel_twins()


def test_registry_builds_seeded_cpu_tensors():
    from torch.utils._pytree import tree_leaves
    names = program_names()
    from repro_torch.core.schemes import registered_schemes
    assert len(names) == len(set(names)) == 2 * len(registered_schemes()) \
        + 2 + 6
    for prog in engine_programs():
        fn, args = prog.build(4)
        assert callable(fn), prog.name
        leaves = tree_leaves(args)
        assert leaves, prog.name
        for leaf in leaves:
            assert type(leaf) is torch.Tensor and leaf.device.type == "cpu", \
                prog.name
        again = tree_leaves(prog.build(4)[1])
        assert all(torch.equal(a, b) for a, b in zip(leaves, again)), \
            prog.name


def _record():
    return json.loads((REPO / scaling.RECORD).read_text())


def test_committed_scaling_record_in_sync_with_registry():
    committed = _record()
    assert set(committed["programs"]) == set(program_names())
    assert committed["k_values"] == list(scaling.K_VALUES)
    for name, rec in committed["programs"].items():
        assert "error" not in rec, f"{name}: {rec.get('error')}"
        assert rec["total_exponent"] is not None, name
        assert not [s for s in rec["sites"] if "violation" in s], name


def test_record_exponents_match_the_reference_record():
    """Each program's total-peak exponent in K is XLA's (the reference's
    committed record, read only) within the drift tolerance.  The one
    program the reference has no record of is the port's moe dispatch
    kernel, which replaces no TPU kernel."""
    ref = json.loads((REPO / "analysis_scaling.json").read_text())
    ours = _record()
    assert set(ours["programs"]) - set(ref["programs"]) == \
        {"kernel[moe_dispatch]"}
    for name, rec in ours["programs"].items():
        if name == "kernel[moe_dispatch]":
            continue
        want = ref["programs"][name]["total_exponent"]
        assert abs(rec["total_exponent"] - want) <= \
            scaling.DRIFT_TOLERANCE, (name, rec["total_exponent"], want)


# ---------------------------------------------------------------------------
# the aten-graph walker
# ---------------------------------------------------------------------------

def test_walker_peak_covers_known_buffer():
    audit = graph_audit.audit_program(quadratic_prog(), k=64)
    assert audit.peak_bytes >= 64 * 64 * 4     # the gram matrix itself
    top = audit.top_buffers(3)
    gram = [b for b in top if b.nbytes == 64 * 64 * 4]
    assert gram and gram[0].site.path == HERE
    assert gram[0].site.line == _line_of("# GRAM:") > 0
    assert gram[0].site.primitive == "mm"


def test_walker_liveness_frees_dead_buffers():
    def two_temps(x):
        a = (x * 2.0).sum()
        b = (x * 3.0).sum()
        return a + b

    prog = EngineProgram(name="fixture[temps]", family="fixture", path=HERE,
                         build=lambda k: (two_temps, (_randn(k),)))
    audit = graph_audit.audit_program(prog, k=4096)
    # input + ONE temp live at a time (plus scalars), never both temps
    assert audit.peak_bytes < 2.5 * 4096 * 4


def test_in_place_ops_and_views_allocate_nothing():
    def aliasing(x):
        y = x.clone()
        y.add_(1.0)
        v = y.view(-1)[:4].t() if y.dim() == 1 else y.view(-1)[:4]
        return v.sum()

    prog = EngineProgram(name="fixture[alias]", family="fixture", path=HERE,
                         build=lambda k: (aliasing, (_randn(k, 8),)))
    audit = graph_audit.audit_program(prog, k=256)
    prims = {s.primitive for s in audit.site_max_bytes}
    assert {"clone", "sum"} <= prims
    assert not prims & {"add_", "view", "slice", "t"}
    # x and its clone at the clone; x is dead by the sum
    assert audit.peak_bytes == 2 * 256 * 8 * 4


def test_walker_follows_loop_vmap_and_cond_bodies():
    """make_fx inlines Python loops and ``torch.func.vmap`` into the graph
    (their bodies are walked where they run); ``torch.cond`` keeps its
    branches as subgraphs, walked by recursion."""
    def looped(x):
        out = x.sum()
        for _ in range(3):
            out = out + (x @ x.T).sum()
        return out

    def vmapped(x):
        return torch.func.vmap(lambda r: torch.outer(r, r).sum())(x.T).sum()

    def conditional(x):
        return torch.cond(x.sum() > -1e9, lambda a: (a @ a.T).sum(),
                          lambda a: a.sum(), (x,))

    for fn, k, floor in ((looped, 64, 64 * 64 * 4), (vmapped, 64,
                                                     8 * 64 * 64 * 4),
                         (conditional, 64, 64 * 64 * 4)):
        prog = EngineProgram(name=f"fixture[{fn.__name__}]",
                             family="fixture", path=HERE,
                             build=lambda k: (fn, (_randn(k, 8),)))
        audit = graph_audit.audit_program(prog, k=k)
        assert audit.peak_bytes >= floor, fn.__name__
        big = max(audit.site_max_bytes.items(), key=lambda kv: kv[1])[0]
        assert big.path == HERE and big.line > 0, (fn.__name__, big)


def test_trace_failure_is_a_finding():
    def boom(x):
        raise ValueError("builder exploded")

    prog = EngineProgram(name="fixture[boom]", family="fixture", path=HERE,
                         build=lambda k: (boom, (_randn(k),)))
    findings, audits = graph_audit.run_graph_audit([prog])
    assert audits == []
    assert len(findings) == 1 and findings[0].rule == "ir-trace"
    assert "exploded" in findings[0].message


# ---------------------------------------------------------------------------
# dtype promotion audit
# ---------------------------------------------------------------------------

def test_implicit_bf16_promotion_fires():
    fs = graph_audit.dtype_promotions(_bf16_prog(_leaky, "fixture[leak]"))
    assert len(fs) == 1 and fs[0].rule == "ir-dtype"
    assert fs[0].path == HERE and fs[0].line == _line_of("# LEAK:") > 0
    assert "mul mints f32 from bf16" in fs[0].message


def test_visible_cast_is_exempt():
    assert graph_audit.dtype_promotions(
        _bf16_prog(_explicit, "fixture[cast]")) == []


def test_f32_program_skips_dtype_audit():
    assert graph_audit.dtype_promotions(
        _bf16_prog(_leaky, "fixture[f32]", compute_dtype="f32")) == []


# ---------------------------------------------------------------------------
# K-scaling gate
# ---------------------------------------------------------------------------

def test_fit_exponent_recovers_powers():
    ks = (4, 16, 64, 256)
    assert scaling.fit_exponent(ks, [k * 7 for k in ks]) == \
        pytest.approx(1.0)
    assert scaling.fit_exponent(ks, [k * k for k in ks]) == \
        pytest.approx(2.0)
    assert scaling.fit_exponent(ks, [1024] * 4) == pytest.approx(0.0)
    assert scaling.fit_exponent(ks, [0, 0, 0, 0]) is None


def test_declared_budget_patterns():
    assert scaling.declared_budget("src/repro_torch/core/fused_round.py") \
        == 1.0
    assert scaling.declared_budget("src/repro_torch/kernels/wkv6/ref.py") \
        == 1.0
    assert scaling.declared_budget("<argument>") == 1.0
    assert scaling.declared_budget(graph_audit.INTERNAL) == 1.0
    assert scaling.declared_budget("tests/somewhere.py") is None
    assert scaling.declared_budget(
        "src/repro_torch/analysis/ir/programs.py") is None


def test_gate_flags_undeclared_quadratic_buffer():
    findings, report = scaling.run_scaling_gate([quadratic_prog()])
    gram = [f for f in findings if f.rule == "ir-scaling"
            and "undeclared" in f.message and "O(K^2" in f.message]
    assert gram, [f.message for f in findings]
    assert gram[0].path == HERE and gram[0].line == _line_of("# GRAM:") > 0


def test_gate_passes_declared_linear_buffer(monkeypatch):
    monkeypatch.setattr(scaling, "DECLARED_BUDGETS",
                        scaling.DECLARED_BUDGETS + (("tests/", 1.0),))
    findings, report = scaling.run_scaling_gate([linear_prog()])
    assert findings == []
    rec = report["programs"]["fixture[rowsum]"]
    assert rec["total_exponent"] == pytest.approx(1.0, abs=0.1)


def test_gate_flags_drift_against_committed(tmp_path):
    _, report = scaling.run_scaling_gate([linear_prog()])
    committed = tmp_path / "scaling.json"
    stale = json.loads(json.dumps(report))
    stale["programs"]["fixture[rowsum]"]["total_exponent"] = 2.0
    committed.write_text(json.dumps(stale))
    drift = scaling._drift_findings(report, committed)
    assert len(drift) == 1 and "drifted" in drift[0].message


def test_gate_missing_committed_record_is_a_finding(tmp_path):
    _, report = scaling.run_scaling_gate([linear_prog()])
    drift = scaling._drift_findings(report, tmp_path / "nope.json")
    assert len(drift) == 1 and "--write-scaling" in drift[0].message


def test_sweep_in_workers_equals_the_sweep_here():
    """Two registry programs swept in two spawned processes, and here."""
    progs = [p for p in engine_programs()
             if p.name in ("kernel[delta_codec]", "kernel[flash_attention]")]
    assert len(progs) == 2
    here = scaling.sweep(progs, jobs=1)
    there = scaling.sweep(progs, jobs=2)
    assert here == there
    assert here[0] == [] and all(
        "error" not in r for r in here[1]["programs"].values())


# ---------------------------------------------------------------------------
# CLI: the fixtures exit 1 with provenance, clean ones 0
# ---------------------------------------------------------------------------

def _main_ir(monkeypatch, progs, *extra):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr("repro_torch.analysis.ir.programs.engine_programs",
                        lambda: progs)
    return main(["--root", str(REPO), "--no-lint", "--no-contracts",
                 "--ir", "--jobs", "1", "--baseline",
                 "no_such_baseline.txt", *extra])


def test_cli_ir_quadratic_fixture_exits_1(monkeypatch, capsys):
    rc = _main_ir(monkeypatch, [quadratic_prog()])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[ir-scaling]" in out
    assert f"{HERE}:{_line_of('# GRAM:')}:" in out    # path:line provenance


def test_cli_ir_promotion_fixture_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(scaling, "DECLARED_BUDGETS",
                        scaling.DECLARED_BUDGETS + (("tests/", 1.0),))
    rc = _main_ir(monkeypatch, [_bf16_prog(_leaky, "fixture[leak]")])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[ir-dtype]" in out and f"{HERE}:{_line_of('# LEAK:')}:" in out


def test_cli_ir_clean_fixture_exits_0(monkeypatch, capsys):
    monkeypatch.setattr(scaling, "DECLARED_BUDGETS",
                        scaling.DECLARED_BUDGETS + (("tests/", 1.0),))
    rc = _main_ir(monkeypatch, [linear_prog(),
                                _bf16_prog(_explicit, "fixture[cast]")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "clean" in out and "ir on cpu" in out


def test_cli_write_scaling_round_trip(monkeypatch, capsys, tmp_path):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(scaling, "DECLARED_BUDGETS",
                        scaling.DECLARED_BUDGETS + (("tests/", 1.0),))
    monkeypatch.setattr("repro_torch.analysis.ir.programs.engine_programs",
                        lambda: [linear_prog()])
    scaling_file = tmp_path / "scaling.json"
    rc = main(["--root", str(REPO), "--write-scaling", "--jobs", "1",
               "--scaling-file", str(scaling_file)])
    assert rc == 0 and scaling_file.exists()
    rec = json.loads(scaling_file.read_text())
    assert set(rec["programs"]) == {"fixture[rowsum]"}
    rc = main(["--root", str(REPO), "--no-lint", "--no-contracts", "--ir",
               "--jobs", "1", "--baseline", "no_such_baseline.txt",
               "--scaling-file", str(scaling_file)])
    capsys.readouterr()
    assert rc == 0
    # a record that no longer holds the program's exponent drifts
    rec["programs"]["fixture[rowsum]"]["total_exponent"] = 2.0
    scaling_file.write_text(json.dumps(rec))
    assert main(["--root", str(REPO), "--no-lint", "--no-contracts", "--ir",
                 "--jobs", "1", "--baseline", "no_such_baseline.txt",
                 "--scaling-file", str(scaling_file)]) == 1


def test_cli_lists_the_ir_rules(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("ir-trace", "ir-dtype", "ir-scaling"):
        assert f"{rule}" in out and "(--ir)" in out


# ---------------------------------------------------------------------------
# the contract checks follow the port's device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", ["check_device_round", "check_fused_round",
                                   "check_kernel_twins"])
def test_contract_checks_default_to_the_card(check):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.analysis import contracts
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(contracts, check)()
