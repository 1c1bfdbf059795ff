"""The port's ``Experiment`` facade (``repro_torch/api.py``): the
reference's facade tests (``tests/test_schemes.py``) on the port.

- A scheme registered in the test runs on the sweep engine with no engine
  edit; every registered scheme runs in one sweep panel, where under
  common random numbers sync's arrivals dominate opt's and opt's
  deadline's, and the robust aggregates change no arrival.
- The facade equals the deprecated shims (``run_sweep``,
  ``run_hsfl_on_device``) metric for metric, and its loop and fused
  engines equal ``HSFLSimulation``'s host and fused rounds.
- It rejects the reference's bad requests in the same words, and without
  a card it raises unless ``device="cpu"`` is passed.
"""
import warnings
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Experiment  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation  # noqa: E402
from repro_torch.core.schemes import (SCHEMES, get_scheme,  # noqa: E402
                                      register_scheme, registered_schemes)

torch.set_num_threads(1)


def tiny(cls=HSFLConfig, **kw):
    base = dict(rounds=2, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=4)
    base.update(kw)
    return cls(**base)


def test_custom_scheme_runs_on_sweep_engine():
    name = "_test_half_deadline"
    try:
        @register_scheme(name)
        class HalfDeadline(get_scheme("deadline").__class__):
            """Deadline variant charging half the eq. 14 allowance."""
            def final_slack(self, tau_extra0):
                return 0.5 * tau_extra0

        res = (Experiment(tiny(rounds=1)).with_scheme(name, b=2.0)
               .run(engine="sweep", mesh=None, device="cpu"))
        assert res.groups[0].scheme == name
        assert np.all(np.isfinite(res.groups[0].metrics["test_loss"]))
    finally:
        SCHEMES.pop(name, None)
    with pytest.raises(ValueError):
        get_scheme(name)


@pytest.fixture(scope="module")
def every_scheme_panel():
    ex = Experiment(tiny(rounds=3, local_epochs=6)).with_seeds(0, 1)
    for s in registered_schemes():
        ex = ex.with_scheme(s, b=3.0)
    return ex.run(engine="sweep", mesh=None, device="cpu")


def test_every_registered_scheme_on_sweep_engine(every_scheme_panel):
    res = every_scheme_panel
    assert [g.scheme for g in res.groups] == list(registered_schemes())
    for g in res.groups:
        m = g.metrics
        assert np.all(np.isfinite(m["test_loss"]))
        assert np.all((m["test_acc"] >= 0) & (m["test_acc"] <= 1))
        assert np.all(m["arrived"] + m["dropped"] + m["delayed"]
                      + m["rescued"] <= m["selected"])
    by = {g.scheme: g.metrics for g in res.groups}
    # common random numbers: waiving the deadline can only add arrivals,
    # charging the eq. 14 overhead only remove them; the robust aggregates
    # change no arrival
    assert np.all(by["sync"]["arrived"] >= by["opt"]["arrived"])
    assert np.all(by["deadline"]["arrived"] <= by["opt"]["arrived"])
    for name in ("opt_trimmed", "opt_median", "opt_clip"):
        np.testing.assert_array_equal(by[name]["arrived"],
                                      by["opt"]["arrived"])
    for name in ("sync", "discard", "async"):
        assert by[name]["rescued"].sum() == 0
    assert by["opt"]["rescued"].sum() > 0


def test_facade_matches_the_shims():
    spec = tsweep.SweepSpec(base=tiny(), seeds=(0,),
                            schemes=(("opt", {"b": 2.0}),
                                     ("deadline", {"b": 2.0})))
    with pytest.warns(DeprecationWarning):
        want = tsweep.run_sweep(spec, device="cpu")
    got = Experiment.from_spec(spec).run(engine="sweep", device="cpu")
    for g1, g2 in zip(got.groups, want.groups):
        assert g1.scheme == g2.scheme
        for key in g1.metrics:
            np.testing.assert_array_equal(g1.metrics[key], g2.metrics[key])
    built = (Experiment(tiny()).with_scheme("opt", b=2.0)
             .with_scheme("deadline", b=2.0).to_spec())
    assert tsweep.compile_spec(built)[0].cfgs == \
        tsweep.compile_spec(spec)[0].cfgs
    cfg = tiny(scheme="discard", b=1)
    with pytest.warns(DeprecationWarning):
        log = tsweep.run_hsfl_on_device(cfg, device="cpu")
    got = Experiment(cfg).run(engine="sweep", device="cpu") \
        .groups[0].sim_log(0, 0)
    assert [r.test_acc for r in got.rounds] == [r.test_acc for r in log.rounds]
    assert len(log.rounds) == 2 and all(r.selected <= 4 for r in log.rounds)


def _traj(cfg):
    sim = HSFLSimulation(cfg, device="cpu")
    delayed, rows = [], []
    for t in range(1, cfg.rounds + 1):
        log, delayed = sim.run_round(t, delayed)
        rows.append((log.selected, log.arrived_final, log.used_snapshot,
                     log.dropped, log.delayed, round(log.bytes_sent, 3)))
    return rows


@pytest.mark.parametrize("engine", ["loop", "fused"])
def test_facade_loop_and_fused_engines(engine):
    cfg = tiny(scheme="opt", b=2, seed=1)
    want = _traj(replace(cfg, use_fused_round=(engine == "fused")))
    log = Experiment(cfg).with_scheme("opt", b=2.0).run(engine=engine,
                                                        device="cpu")
    got = [(r.selected, r.arrived_final, r.used_snapshot, r.dropped,
            r.delayed, round(r.bytes_sent, 3)) for r in log.rounds]
    assert got == want
    two = Experiment(cfg).with_seeds(0, 1).run(engine=engine, device="cpu")
    assert isinstance(two, list) and len(two) == 2


def test_facade_rejects_bad_requests():
    ex = Experiment(tiny())
    with pytest.raises(ValueError, match="engine"):
        ex.run(engine="warp", device="cpu")
    with pytest.raises(ValueError, match="sweep"):
        ex.with_scheme("opt").with_scheme("async").run(engine="fused",
                                                       device="cpu")
    with pytest.raises(ValueError, match="sweep"):
        ex.with_axes(b=(1.0, 2.0)).run(engine="fused", device="cpu")
    with pytest.raises(ValueError, match="traced config axes"):
        ex.with_axes(rounds=(3,))
    with pytest.raises(ValueError, match="fractional"):
        ex.with_scheme("opt", b=2.5).run(engine="fused", device="cpu")
    with pytest.raises(ValueError, match="only apply to the sweep"):
        ex.run(engine="loop", device="cpu", timeit=True)
    frozen = Experiment.from_spec(tsweep.SweepSpec(base=tiny()))
    with pytest.raises(ValueError, match="from_spec"):
        frozen.with_scheme("deadline", b=2.0)
    with pytest.raises(ValueError, match="from_spec"):
        frozen.with_seeds(0, 1)
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        ex.run(engine="sweep", mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.run(engine="sweep")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.serve()


def test_facade_serve_builds_the_server(tmp_path):
    server = Experiment(tiny()).with_scheme("opt", b=2.0).serve(
        ckpt_dir=str(tmp_path), device="cpu")
    assert server.cfg.scheme == "opt" and server.cfg.b == 2
    with pytest.raises(ValueError, match="one simulation"):
        Experiment(tiny()).with_seeds(0, 1).to_config()


def test_scheme_pins_and_identity():
    opt = get_scheme("opt")
    pinned = opt.with_pins(b=2.0, use_delta_codec=True)
    assert pinned.pins == (("b", 2.0), ("use_delta_codec", True))
    assert pinned == opt.with_pins(use_delta_codec=True, b=2.0)
    assert pinned != opt and hash(pinned) == hash(opt.with_pins(
        b=2.0, use_delta_codec=True))
    assert pinned.name == "opt" and get_scheme(pinned) is pinned
    assert get_scheme("discard").lowered_program((1.0,)) == "opt"
    assert get_scheme("discard").lowered_program((2.0,)) == "discard"
    assert get_scheme("opt").with_pins(b=1.0) != \
        get_scheme("deadline").with_pins(b=1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert get_scheme("async").lowered_program((1.0,)) == "async"


def test_from_spec_refusal_and_overlap_compile_match_the_reference():
    """``from_spec``'s refusal has the reference's words, and ``run``
    passes ``overlap_compile`` through to the sweep engine, which takes it
    (there is no compile to overlap: the metrics do not move)."""
    jax_api = pytest.importorskip("repro.api")
    jax_sweep = pytest.importorskip("repro.core.sweep")
    from repro.core.hsfl import HSFLConfig as JConfig
    with pytest.raises(ValueError) as want:
        jax_api.Experiment.from_spec(
            jax_sweep.SweepSpec(base=tiny(JConfig))).with_seeds(0, 1)
    with pytest.raises(ValueError) as got:
        Experiment.from_spec(tsweep.SweepSpec(base=tiny())).with_seeds(0, 1)
    assert str(got.value) == str(want.value)
    assert "builder methods would be ignored" in str(got.value)
    ex = Experiment(tiny(rounds=1)).with_scheme("opt", b=2.0)
    on = ex.run(engine="sweep", device="cpu", overlap_compile=True)
    off = ex.run(engine="sweep", device="cpu", overlap_compile=False)
    for key in on.groups[0].metrics:
        np.testing.assert_array_equal(on.groups[0].metrics[key],
                                      off.groups[0].metrics[key])
