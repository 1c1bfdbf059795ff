"""repro_torch.analysis: findings, the lint engine, its rules and the CLI.

The parity half holds the port's engine to the reference's
(``repro.analysis``) where the two share a meaning: the findings layer
byte for byte, the traced-scope map on idioms both engines know, and the
rules whose logic carries over unchanged (``scheme-branch``, ``np-hot``,
``except-swallow``) on the reference's own fixtures, with the path mapped
from ``src/repro/`` to ``src/repro_torch/``.  The fixture half pins both
directions of every rule in torch's idioms.  The CLI half runs
``python -m repro_torch.analysis`` on temp trees and on the repo.
"""
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis.findings as jf
import repro.analysis.lint as jlint
from repro_torch.analysis import findings as tf
from repro_torch.analysis import lint as tlint

REPO = Path(__file__).resolve().parents[1]

CORE = "src/repro_torch/core/somemod.py"
KERN = "src/repro_torch/kernels/somepkg/kernel.py"
MODEL = "src/repro_torch/models/somemod.py"


def _jax_fixtures():
    """The reference's fixture module (``tests/test_analysis.py``)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_analysis_fixtures", REPO / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def findings_for(src, relpath, rule=None):
    out = tlint.lint_source(textwrap.dedent(src), relpath)
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


# ---------------------------------------------------------------------------
# findings: byte parity with the reference
# ---------------------------------------------------------------------------

ROWS = [
    ("src/a.py", 3, 1, "np-hot", "first\nsecond % line", "np.mean(x)"),
    ("src/a.py", 7, 4, "host-sync", "msg", "x.item()  # analysis: ok"),
    ("src/b.py", 0, 0, "ir-alias", "dropped", ""),
    ("src/b.py", 2, 8, "rng-reuse", "twice\r", "g.manual_seed(s)"),
    ("src/c.py", 5, 0, "dtype-thread", "cast",
     "y.float()  # analysis: ok=dtype-thread"),
    ("src/c.py", 6, 0, "np-hot", "m", "np.sum(x)  # analysis: ok=host-sync"),
]
SOURCES = {
    "src/a.py": ["", "", "np.mean(x)", "", "", "", "x.item()  # analysis: ok"],
    "src/c.py": ["", "", "", "", "y.float()  # analysis: ok=dtype-thread",
                 "np.sum(x)  # analysis: ok=host-sync"],
}


def _both():
    return ([jf.Finding(*r) for r in ROWS], [tf.Finding(*r) for r in ROWS])


def _rows(findings):
    return [(f.path, f.line, f.col, f.rule, f.message, f.snippet)
            for f in findings]


def test_findings_render_and_format_match_the_reference():
    jfs, tfs = _both()
    assert tf.render_text(tfs) == jf.render_text(jfs)
    assert tf.render_github(tfs) == jf.render_github(jfs)
    assert tf.Baseline.render(tfs) == jf.Baseline.render(jfs)
    assert tf.Baseline.render(tfs, why="ok") == jf.Baseline.render(jfs,
                                                                    why="ok")
    assert [f.key() for f in tfs] == [f.key() for f in jfs]
    assert [f.format() for f in tfs] == [f.format() for f in jfs]
    desc = {"np-hot": "numpy in hot path"}
    tdoc = json.loads(tf.render_sarif(tfs, desc))
    jdoc = json.loads(jf.render_sarif(jfs, desc))
    assert tdoc["runs"][0]["tool"]["driver"].pop("name") == \
        "repro_torch.analysis"
    assert jdoc["runs"][0]["tool"]["driver"].pop("name") == "repro.analysis"
    assert tdoc == jdoc


@pytest.mark.parametrize("line", [
    "x = 1", "x  # analysis: ok", "x  # analysis: ok=np-hot",
    "x  #analysis:ok=np-hot,host-sync", "x  # analysis: ok=dtype-thread (why)",
    "x  # analysis: okay", "x  # analysis ok=np-hot"])
def test_pragma_rules_match_the_reference(line):
    assert tf.pragma_rules(line) == jf.pragma_rules(line)
    for rule in ("np-hot", "host-sync", "dtype-thread"):
        ft, fj = (mod.Finding("p.py", 1, 0, rule, "m", line)
                  for mod in (tf, jf))
        assert tf.suppressed_by_pragma(ft, [line]) == \
            jf.suppressed_by_pragma(fj, [line])


def test_baseline_load_covers_stale_and_filter_match_the_reference(tmp_path):
    jfs, tfs = _both()
    text = tf.Baseline.render(tfs[:3], why="reviewed") \
        + "src/gone.py :: np-hot :: np.x() :: was reviewed, file deleted\n"
    path = tmp_path / "baseline.txt"
    path.write_text(text)
    tb, jb = tf.Baseline.load(path), jf.Baseline.load(path)
    assert tb.entries == jb.entries
    assert [tb.covers(f) for f in tfs] == [jb.covers(f) for f in jfs]
    assert tb.stale() == jb.stale() == [("src/gone.py", "np-hot", "np.x()")]
    tb2, jb2 = tf.Baseline.load(path), jf.Baseline.load(path)
    assert _rows(tf.filter_findings(tfs, tb2, SOURCES)) == \
        _rows(jf.filter_findings(jfs, jb2, SOURCES))
    assert tb2.stale() == jb2.stale()
    assert tf.Baseline.load(tmp_path / "missing.txt").entries == {}
    bad = tmp_path / "bad.txt"
    for body in ("a :: b :: c\n", "a :: b :: c ::  \n"):
        bad.write_text(body)
        with pytest.raises(ValueError) as te:
            tf.Baseline.load(bad)
        with pytest.raises(ValueError) as je:
            jf.Baseline.load(bad)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# traced scope: parity on the idioms both engines share
# ---------------------------------------------------------------------------

SCOPE_FIXTURES = {
    "builder nesting": """
        def build_round(k):
            def body(c, x):
                def inner(y):
                    return y
                return inner(c) + x
            helper = lambda z: z * k
            return body, helper

        def host(x):
            def not_traced(y):
                return y
            return not_traced(x)

        def _make_step():
            def step(x):
                return x
            return step
        """,
    "partial decorators": """
        from functools import partial

        @partial(vmap, in_dims=0)
        def batched(x):
            def nested(y):
                return y
            return nested(x)

        @partial(grad)
        def loss(w):
            return w

        @partial(print, 1)
        def plain(x):
            return x
        """,
    "closures over vmap/grad/checkpoint": """
        import functools

        def run(xs):
            def per_row(x):
                return x * 2
            def loss(w):
                def deep(v):
                    return v
                return deep(w)
            def block(h):
                return h
            def unused(h):
                return h
            a = vmap(per_row)(xs)
            g = grad(functools.partial(loss))(xs)
            c = checkpoint(block, xs)
            d = vmap(lambda t: t + 1)(xs)
            return a, g, c, d
        """,
}


def _traced(mod, src):
    import ast
    src = textwrap.dedent(src)
    ctx = mod.ModuleContext("src/x/core/m.py", src, ast.parse(src))
    return sorted((n.lineno, getattr(n, "name", "<lambda>"))
                  for n in ast.walk(ctx.tree) if id(n) in ctx.traced)


@pytest.mark.parametrize("fixture", sorted(SCOPE_FIXTURES))
def test_traced_scope_matches_the_reference(fixture):
    src = SCOPE_FIXTURES[fixture]
    got, want = _traced(tlint, src), _traced(jlint, src)
    assert got == want
    assert got                                      # the fixture bites


def test_traced_scope_knows_torch_transforms_and_autograd_functions():
    src = """
    import torch

    class Fwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x
        @staticmethod
        def backward(ctx, g):
            return g
        @staticmethod
        def setup_context(ctx, inputs, output):
            pass
        def helper(self):
            return 1

    class NotAutograd:
        def forward(self, x):
            return x

    @torch.compile
    def compiled(x):
        return x

    def host(fn, x):
        def jac(y):
            return y
        def graphed(y):
            return y
        torch.func.jacrev(jac)(x)
        torch.cuda.make_graphed_callables(graphed, (x,))
        return fn
    """
    assert [name for _, name in _traced(tlint, src)] == [
        "forward", "backward", "setup_context", "compiled", "jac", "graphed"]
    # the reference knows none of these torch idioms
    assert _traced(jlint, src) == []


# ---------------------------------------------------------------------------
# rules shared with the reference: path-mapped parity on its fixtures
# ---------------------------------------------------------------------------

NP_HOT = {
    "fires": """
    import numpy as np

    def agg(x):
        return np.mean(x)
    """,
    "constants": """
    import numpy as np

    def agg(x):
        return x * np.pi + np.float32(0)
    """,
    "random": """
    import numpy as np

    def agg(x):
        return np.random.normal(size=3) + np.linalg.norm(x)
    """,
}


def _parity_cases():
    fx = _jax_fixtures()
    cases = []
    for path in ("core/somemod.py", "core/schemes.py", "core/fused_round.py",
                 "analysis/x.py", "serving/server.py"):
        cases.append(("scheme-branch", fx.SCHEME_BRANCH, path))
    cases.append(("scheme-branch", """
    def f(mode, x):
        if mode == "fast":
            return x
    """, "core/somemod.py"))
    for name, src in sorted(NP_HOT.items()):
        for path in ("core/fused_round.py", "core/channel_lib.py",
                     "kernels/pkg/ref.py", "core/metrics.py"):
            cases.append(("np-hot", src, path))
    for path in ("serving/fl_server.py", "core/transport.py",
                 "core/faults.py", "core/somemod.py", "kernels/p/kernel.py"):
        cases.append(("except-swallow", fx.SWALLOW, path))
    cases.append(("except-swallow", """
    def recv(sock, log):
        try:
            return sock.read()
        except TimeoutError:
            pass
        except Exception as exc:
            log.warning("recv failed: %s", exc)
    """, "serving/fl_server.py"))
    return cases


_CASES = _parity_cases()


@pytest.mark.parametrize("i", range(len(_CASES)))
def test_shared_rules_match_the_reference_path_mapped(i):
    rule, src, sub = _CASES[i]
    src = textwrap.dedent(src)
    jrules = [r for r in jlint.all_rules() if r.name == rule]
    trules = [r for r in tlint.all_rules() if r.name == rule]
    want = jlint.lint_source(src, f"src/repro/{sub}", jrules)
    got = tlint.lint_source(src, f"src/repro_torch/{sub}", trules)
    assert [f.path for f in got] == [f"src/repro_torch/{sub}"] * len(got)
    norm = (lambda m: m.replace("use jnp", "use torch")) \
        if rule == "np-hot" else (lambda m: m)
    assert [(f.line, f.col, f.rule, norm(f.message), f.snippet)
            for f in got] == \
        [(f.line, f.col, f.rule, norm(f.message), f.snippet) for f in want]


def test_rule_registry_is_the_reference_minus_jit_donate():
    tnames = {r.name for r in tlint.all_rules()}
    jnames = {r.name for r in jlint.all_rules()}
    assert tnames == jnames - {"jit-donate"}
    assert len(tnames) == 6


# ---------------------------------------------------------------------------
# the six rules in torch's idioms
# ---------------------------------------------------------------------------

def test_scheme_branch_fires_in_the_port_but_not_in_its_registry():
    src = _jax_fixtures().SCHEME_BRANCH
    assert {f.line for f in findings_for(src, CORE, "scheme-branch")} == \
        {3, 5}
    assert not findings_for(src, "src/repro_torch/core/schemes.py",
                            "scheme-branch")
    assert not findings_for(src, "src/repro_torch/analysis/contracts.py",
                            "scheme-branch")
    assert not findings_for(src, "src/repro/core/somemod.py",
                            "scheme-branch")


def test_np_hot_fires_on_host_compute_not_on_constants():
    got = findings_for(NP_HOT["fires"], "src/repro_torch/kernels/x/ops.py",
                       "np-hot")
    assert len(got) == 1 and "use torch" in got[0].message
    assert not findings_for(NP_HOT["constants"],
                            "src/repro_torch/core/channel_lib.py", "np-hot")
    assert not findings_for(NP_HOT["fires"], "src/repro_torch/core/sweep.py",
                            "np-hot")


HOST_SYNC_BAD = """
import time
import numpy as np
import torch

def build_round(k):
    def round_fn(x, mask):
        a = x.item()
        b = x.tolist()
        c = x.cpu()
        d = x.numpy()
        e = x.to("cpu")
        f = x.to(device="cpu:0")
        torch.cuda.synchronize()
        g = torch.nonzero(mask)
        h = x.masked_select(mask)
        i = torch.unique(x)
        j = torch.where(mask)
        k2 = np.asarray(x)
        t0 = time.perf_counter()
        n = float(x.sum())
        return a
    return round_fn
"""


def test_host_sync_flags_torch_syncs_in_traced_scope():
    got = sorted(findings_for(HOST_SYNC_BAD, CORE, "host-sync"),
                 key=lambda f: f.line)
    assert [f.line for f in got] == list(range(8, 22))
    assert "data-dependent output shape" in got[7].message
    assert "host's enqueue" in got[13 - 1].message
    # the same body in host code is legal, and outside core/ kernels/ too
    host = HOST_SYNC_BAD.replace("def build_round", "def run_round")
    assert not findings_for(host, CORE, "host-sync")
    assert not findings_for(HOST_SYNC_BAD, "src/repro_torch/serving/x.py",
                            "host-sync")


def test_host_sync_allows_static_values_and_three_argument_where():
    src = """
    import torch

    def make_step():
        def step(x, m):
            a = float(x.shape[0]) + int(x.size(0)) + int(x.numel())
            b = float(x.dim()) + float(len(x)) + int(2.5)
            c = torch.where(m, x, 0.0)
            d = x.to("cuda") + x.to(torch.float32)
            return a + b + c + d
        return step
    """
    assert not findings_for(src, KERN, "host-sync")


def test_host_sync_sees_autograd_functions_and_transforms():
    src = """
    import torch

    class K(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * x.item()

        @staticmethod
        def backward(ctx, g):
            return g.cpu()

    def outer(xs):
        def per(x):
            return float(x)
        return torch.func.vmap(per)(xs), xs.item()
    """
    got = findings_for(src, KERN, "host-sync")
    assert sorted(f.line for f in got) == [7, 11, 15]


def test_dtype_thread_flags_unused_policy_and_hard_casts():
    src = """
    import numpy as np
    import torch

    def unused(params, x, compute_dtype=None):
        return x @ params

    def casts(x, dtype=torch.float32):
        a = x.to(dtype)
        b = x.to(torch.float32)
        c = x.to(dtype=torch.bfloat16)
        d = x.to(x.device, torch.float16)
        e = x.float()
        f = x.half()
        g = x.bfloat16()
        h = x.type(torch.float32)
        i = np.ones(3).astype(np.float32)
        return a, b, c, d, e, f, g, h, i
    """
    got = sorted(findings_for(src, KERN, "dtype-thread"),
                 key=lambda f: f.line)
    assert [f.line for f in got] == [5] + list(range(10, 18))
    assert "compute_dtype" in got[0].message
    assert ".to(torch.bfloat16)" in got[2].message


def test_dtype_thread_allows_threaded_and_pragmad_casts():
    src = """
    import torch

    def threaded(x, compute_dtype=None, out_dtype=torch.float32):
        y = x.to(compute_dtype).to(torch.int8)
        return y.to(dtype=out_dtype)

    def no_policy(x):
        return x.float()

    def pinned(x, dtype=None):
        return x.to(dtype).float()  # analysis: ok=dtype-thread
    """
    raw = findings_for(src, MODEL, "dtype-thread")
    assert [f.line for f in raw] == [12]
    kept = tf.filter_findings(raw, tf.Baseline(),
                              {MODEL: textwrap.dedent(src).splitlines()})
    assert kept == []
    assert not findings_for(src.replace("threaded", "t").replace(
        "pinned(x, dtype=None)", "pinned(x, dtype)"), CORE, "dtype-thread")


def test_rng_reuse_flags_draws_without_a_generator():
    src = """
    import torch
    from torch import nn

    def init(shape, g):
        a = torch.rand(shape)
        b = torch.randn(shape, generator=g)
        c = torch.randint(0, 5, shape)
        d = torch.empty(shape).uniform_()
        e = torch.empty(shape).normal_(generator=g)
        nn.init.kaiming_uniform_(d)
        torch.nn.init.normal_(d, generator=g)
        torch.nn.init.zeros_(d)
        f = torch.multinomial(a, 2)
        return a, b, c, d, e, f
    """
    got = sorted(findings_for(src, CORE, "rng-reuse"), key=lambda f: f.line)
    assert [f.line for f in got] == [6, 8, 9, 11, 14]
    assert "global stream" in got[0].message
    assert not findings_for(src, "src/repro_torch/analysis/x.py",
                            "rng-reuse")


def test_rng_reuse_flags_a_seed_replayed_on_one_path():
    src = """
    import torch

    def two(seed):
        a = torch.Generator().manual_seed(seed)
        b = torch.Generator().manual_seed(seed)
        return a, b
    """
    got = findings_for(src, CORE, "rng-reuse")
    assert len(got) == 1 and got[0].line == 6
    assert "already seeded" in got[0].message


def test_rng_reuse_flags_a_loop_reseeding_from_outside():
    src = """
    import torch

    def draws(seed, g):
        out = []
        for i in range(4):
            g.manual_seed(seed)
            out.append(torch.rand(3, generator=g))
        return out
    """
    got = findings_for(src, CORE, "rng-reuse")
    assert len(got) == 1 and "loop" in got[0].message


def test_rng_reuse_allows_fresh_seeds_branches_and_rebinding():
    src = """
    import torch

    def fresh(seed, flag, g):
        out = []
        for i in range(4):
            g.manual_seed(seed + i)
            out.append(torch.rand(3, generator=g))
        for i in range(4):
            s = seed * 7 + i
            g.manual_seed(s)
        for i in range(4):
            seed = seed + 1
            g.manual_seed(seed)
        return out

    def branches(seed, flag, g):
        if flag:
            g.manual_seed(seed)
        else:
            g.manual_seed(seed)
        return g

    def one(seed):
        return torch.Generator().manual_seed(seed)
    """
    assert not findings_for(src, CORE, "rng-reuse")


def test_except_swallow_fires_in_the_port_scope_only():
    src = _jax_fixtures().SWALLOW
    for path in ("src/repro_torch/serving/decode.py",
                 "src/repro_torch/core/transport.py",
                 "src/repro_torch/core/faults.py"):
        assert {f.line for f in findings_for(src, path,
                                             "except-swallow")} == {6, 10}
    assert not findings_for(src, CORE, "except-swallow")


def test_syntax_error_is_a_finding():
    got = tlint.lint_source("def broken(:\n", CORE)
    assert len(got) == 1 and got[0].rule == "syntax"


# ---------------------------------------------------------------------------
# CLI end to end
# ---------------------------------------------------------------------------

VIOLATION = """import torch

def draw(shape):
    return torch.rand(shape)
"""
CLEAN = """import torch

def draw(shape, g):
    return torch.rand(shape, generator=g)
"""
BASELINE = "src/repro_torch/analysis/baseline.txt"


def _run_cli(root, *extra, contracts=False):
    args = [] if contracts else ["--no-contracts"]
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root", str(root),
         *args, *extra],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(root)})


@pytest.fixture
def tmp_tree(tmp_path):
    mod = tmp_path / "src" / "repro_torch" / "core"
    mod.mkdir(parents=True)
    (mod / "bad.py").write_text(VIOLATION)
    (tmp_path / "src" / "repro_torch" / "analysis").mkdir()
    return tmp_path


def test_cli_exits_nonzero_on_violation(tmp_tree):
    res = _run_cli(tmp_tree)
    assert res.returncode == 1
    assert "[rng-reuse]" in res.stdout
    assert "src/repro_torch/core/bad.py:4" in res.stdout


def test_cli_baseline_silences_and_clean_tree_exits_zero(tmp_tree):
    res = _run_cli(tmp_tree, "--write-baseline")
    assert res.returncode == 0 and "bad.py :: rng-reuse" in res.stdout
    (tmp_tree / BASELINE).write_text(
        res.stdout.replace("TODO: one-line justification", "reviewed"))
    res2 = _run_cli(tmp_tree)
    assert res2.returncode == 0, res2.stdout + res2.stderr
    assert "clean (lint)" in res2.stdout
    (tmp_tree / BASELINE).unlink()
    (tmp_tree / "src" / "repro_torch" / "core" / "bad.py").write_text(CLEAN)
    res3 = _run_cli(tmp_tree)
    assert res3.returncode == 0 and "clean" in res3.stdout


STALE_ENTRY = ("src/repro_torch/core/gone.py :: rng-reuse :: "
               "return torch.rand(shape) :: was reviewed, file deleted\n")


def test_cli_strict_and_prune_baseline(tmp_tree):
    res = _run_cli(tmp_tree, "--write-baseline")
    (tmp_tree / BASELINE).write_text(
        res.stdout.replace("TODO: one-line justification", "reviewed")
        + STALE_ENTRY)
    res = _run_cli(tmp_tree)
    assert res.returncode == 0 and "stale baseline entry" in res.stderr
    res = _run_cli(tmp_tree, "--strict-baseline")
    assert res.returncode == 1 and "stale" in res.stderr
    res = _run_cli(tmp_tree, "--prune-baseline", "--strict-baseline")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "pruned 1 stale" in res.stderr
    kept = (tmp_tree / BASELINE).read_text()
    assert "gone.py" not in kept and "bad.py" in kept
    assert _run_cli(tmp_tree, "--strict-baseline").returncode == 0


def test_cli_formats_and_rule_list(tmp_tree):
    res = _run_cli(tmp_tree, "--format", "github")
    assert res.returncode == 1
    assert "::error file=src/repro_torch/core/bad.py,line=4" in res.stdout
    res = _run_cli(tmp_tree, "--format", "sarif")
    assert res.returncode == 1
    doc = json.loads(res.stdout)
    assert doc["runs"][0]["tool"]["driver"]["name"] == "repro_torch.analysis"
    assert doc["runs"][0]["results"][0]["ruleId"] == "rng-reuse"
    res = _run_cli(tmp_tree, "--list-rules")
    assert res.returncode == 0
    from repro_torch.analysis.__main__ import IR_RULE_DESCRIPTIONS
    assert [ln.split()[0] for ln in res.stdout.splitlines()] == sorted(
        r.name for r in tlint.all_rules()) + sorted(IR_RULE_DESCRIPTIONS)


def test_repo_tree_is_clean_with_contracts_on_the_cpu():
    """The port's own findings are all fixed, pragma'd or baselined, and
    the contract sweep is clean on the CPU; no baseline entry is stale."""
    res = _run_cli(REPO, "--device", "cpu", "--strict-baseline",
                   contracts=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "clean (lint + contracts on cpu)" in res.stdout


def test_cli_wants_the_card_without_device(monkeypatch, capsys):
    import torch

    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--root", str(REPO)])
    assert main(["--root", str(REPO), "--no-contracts"]) == 0
    assert "clean (lint)" in capsys.readouterr().out
