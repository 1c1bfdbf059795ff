"""The port's fused HSFL round on the CPU against the JAX fused engine.

Both packages run the same configuration from the same initial params (the
JAX init, handed across as numpy).  The control plane draws everything
from the same numpy streams and decides in f32 on both sides, so the
per-round (selected, arrived, rescued, delayed, dropped, bytes_sent) must
be equal.  Params differ only by f32 summation order inside the training
step (~1e-8 per round at this size); 1e-4 leaves ample margin.  opt_clip
gets 5e-4: its global L2 norms reduce in another order, and the clip scale
amplifies that (the envelope the reference's own host-vs-fused pin uses).
Test loss agrees to 1e-4; accuracy to one test image.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.hsfl import HSFLConfig as JConfig  # noqa: E402
from repro.core.hsfl import HSFLSimulation as JSim  # noqa: E402
from repro.core.schemes import registered_schemes  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation  # noqa: E402

torch.set_num_threads(1)


def _cfg(cls, scheme, **kw):
    # the reference's pallas-vs-xla round config (tests/test_fused_cnn.py);
    # seed 4 rescues a snapshot in round 2 (opt family), so the rescue
    # aggregation is exercised
    base = dict(rounds=2, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=3, scheme=scheme, seed=4,
                b=2 if scheme.startswith("opt") or scheme == "deadline"
                else 1)
    base.update(kw)
    return cls(**base)


def _run(sim):
    rows, delayed = [], []
    for t in range(1, sim.cfg.rounds + 1):
        log, delayed = sim.run_round(t, delayed)
        loss, acc = sim.evaluate()
        rows.append(((log.selected, log.arrived_final, log.used_snapshot,
                      log.delayed, log.dropped, log.bytes_sent), loss, acc))
    return rows


CASES = [(s, {}) for s in sorted(registered_schemes())] + [
    # 3 UAVs for 4 slots: the cohort is padded with a zero phantom user
    # (label 0, valid=False) that still trains, as in the reference
    ("opt", {"n_uavs": 3}), ("async", {"n_uavs": 3})]


@pytest.mark.parametrize(
    "scheme,extra", CASES,
    ids=[s + ("-phantom" if kw else "") for s, kw in CASES])
def test_port_round_matches_jax_fused_engine(scheme, extra):
    jsim = JSim(_cfg(JConfig, scheme, **extra))
    tsim = HSFLSimulation(_cfg(HSFLConfig, scheme, **extra), device="cpu")
    init = jax.tree_util.tree_map(np.asarray, jsim.params)
    tsim.params = params_from_numpy(init, "cpu")
    want, got = _run(jsim), _run(tsim)
    assert [r[0] for r in got] == [r[0] for r in want]
    if scheme == "opt" and not extra:
        assert sum(r[0][2] for r in got) > 0, "fixture no longer rescues"
    if extra:
        assert any(r[0][0] % 2 for r in got), "fixture no longer pads"
    tol = 5e-4 if scheme == "opt_clip" else 1e-4
    jp = jax.tree_util.tree_map(np.asarray, jsim.params)
    tp = params_to_numpy(tsim.params)
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_allclose(tp[layer][leaf], jp[layer][leaf],
                                       rtol=0, atol=tol,
                                       err_msg=f"{layer}.{leaf}")
    for (_, tl, ta), (_, jl, ja) in zip(got, want):
        assert abs(tl - jl) <= 1e-4
        assert abs(ta - ja) <= 1.0 / 100 + 1e-9


def test_unported_engines_raise():
    """Every engine and policy the reference accepts runs (the host engine,
    the codec, and now bf16, the single-user kernels and im2col: one round
    each, counts logged, params f32 and finite); a bad kernel name still
    raises.  Parity with the reference is in the other tests."""
    for kw in ({"use_fused_round": False}, {"use_delta_codec": True}):
        sim = HSFLSimulation(HSFLConfig(n_train=100, n_test=20, n_uavs=4,
                                        **kw), device="cpu")
        assert sim.cfg.use_fused_round == kw.get("use_fused_round", True)
    for kw in ({"precision": "bf16"}, {"batch_users": False},
               {"kernel": "im2col", "precision": "bf16"}):
        sim = HSFLSimulation(HSFLConfig(n_train=100, n_test=20, n_uavs=4,
                                        k_select=2, local_epochs=1,
                                        steps_per_epoch=1, **kw),
                             device="cpu")
        log, _ = sim.run_round(1, [])
        assert log.selected >= 0
        for t in jax.tree_util.tree_leaves(params_to_numpy(sim.params)):
            assert t.dtype == np.float32 and np.isfinite(t).all()
    with pytest.raises(ValueError, match="kernel"):
        HSFLSimulation(HSFLConfig(kernel="nope", n_train=100, n_test=20,
                                  n_uavs=4), device="cpu")
