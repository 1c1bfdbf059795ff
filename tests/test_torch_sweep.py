"""The port's sweep engine and ``Experiment`` facade against the JAX
package's.

- ``compile_spec`` gives the reference's groups, config columns, labels,
  statics and program schemes for every spec of the reference's sweep
  tests and for ``fig3a_spec`` ... ``fig3d_spec``.
- The port's sweep against the reference's ``_run_sweep(mesh=None)`` on
  the same panels, with the reference's draws replayed
  (``test_torch_device_round.JaxReplay``): every (S, C, rounds) count
  exactly equal, bytes_sent within rel 1e-6, test loss within 1e-4,
  accuracy within one test image.
- The port's own contracts: a codec Fig. 3(b) panel is 2 programs
  (``program_id == [0, 1, 0]``); the lowered discard equals the dedicated
  discard bit for bit; two runs are equal bit for bit; a row's counts,
  bytes and params equal its simulation run alone bit for bit, its test
  loss within 1e-6 and accuracy within one test image (the eval's CPU
  twins may block their batched products differently for another number
  of models; ``chip_smoke.py`` holds the card's kernels to every metric
  bit for bit); the folded config axis equals each
  config run alone (counts exact, params within 1e-6: the twins' batched
  products may block differently for another cohort size).
- ``_stack_sims`` builds a group's simulations on threads: its stacked
  arrays equal serial ``build_sim_arrays(..., pad_len=m)`` calls stacked,
  and the reference's at the paper's sizes; the counters
  ``sweep.sims_built`` and ``sweep.sims_built_concurrently``.
The facade's tests are in ``test_torch_api.py``.
"""
import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import hsfl as jhsfl  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig  # noqa: E402
from repro_torch.core.streams import TorchStream  # noqa: E402
from repro_torch.utils import trace  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402
from test_torch_device_round import replay_factory  # noqa: E402

torch.set_num_threads(1)
COUNTS = ("selected", "arrived", "rescued", "delayed", "dropped")


def tiny(cls=HSFLConfig, **kw):
    base = dict(rounds=2, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=4)
    base.update(kw)
    return cls(**base)


def specs(mod, cls):
    """The reference's sweep-test specs, built from either package."""
    S = mod.SweepSpec
    out = [
        S(base=tiny(cls), seeds=(0, 1), distributions=("iid", "noniid"),
          schemes=(("opt", {"b": 2.0}), ("discard", {"b": 1.0})),
          tau_max=(8.0, 9.0)),
        S(base=tiny(cls), seeds=(0,), b=(1.0, 2.0, 3.0)),
        S(base=tiny(cls), b=(4.0,)),
        S(base=tiny(cls), seeds=(0,),
          schemes=(("opt", {"b": 2.0}),
                   ("opt", {"b": 2.0, "use_delta_codec": True}),
                   ("discard", {"b": 1.0}))),
        S(base=tiny(cls), schemes=(("discard", {"b": 2.0}),)),
        S(base=tiny(cls, rounds=2, local_epochs=4), seeds=(0,),
          schemes=(("opt", {"b": 2.0, "use_delta_codec": True}),
                   ("opt", {"b": 2.0, "use_delta_codec": True,
                            "codec_bits": 4}))),
        S(base=tiny(cls, use_delta_codec=True), seeds=(0, 1),
          schemes=(("opt", {"b": 2.0}), ("async", {"b": 1.0}),
                   ("discard", {"b": 1.0}))),
        S(base=tiny(cls), seeds=(0,),
          schemes=(("opt", {"b": 2.0, "kernel": "pallas",
                            "precision": "bf16", "batch_users": False}),)),
    ]
    for fig in ("fig3a_spec", "fig3b_spec", "fig3c_spec", "fig3d_spec"):
        out += getattr(mod, fig)(rounds=2)
    return out


def group_view(g):
    from dataclasses import asdict
    return (g.scheme, asdict(g.base), g.sims, g.cfgs, g.label,
            g.program_scheme)


@pytest.mark.parametrize("i", range(12))
def test_compile_spec_matches_jax(i):
    js, ts = specs(jsweep, jhsfl.HSFLConfig)[i], specs(tsweep, HSFLConfig)[i]
    for lower in (True, False):
        want = [group_view(g) for g in jsweep.compile_spec(js, lower)]
        got = [group_view(g) for g in tsweep.compile_spec(ts, lower)]
        assert got == want


def test_compile_spec_rejections_match_jax():
    for mod, cls in ((jsweep, jhsfl.HSFLConfig), (tsweep, HSFLConfig)):
        with pytest.raises(ValueError, match="neither a traced"):
            mod.compile_spec(mod.SweepSpec(base=tiny(cls),
                                           schemes=(("opt", {"rounds": 3}),)))
        with pytest.raises(ValueError, match="schedule_override"):
            mod.compile_spec(mod.SweepSpec(
                base=tiny(cls, schedule_override=(1,)), b=(1.0, 2.0)))
        with pytest.raises(ValueError, match="registered schemes"):
            mod.compile_spec(mod.SweepSpec(base=tiny(cls),
                                           schemes=("bogus",)))
    assert tsweep.compile_spec(specs(tsweep, HSFLConfig)[1])[0].base.b \
        == tsweep.B_SWEPT


# -- the port's sweep vs the reference's, on replayed draws -------------------

def assert_metrics_match(got, want, n_test):
    for key in COUNTS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["bytes_sent"].astype(np.float64),
                               want["bytes_sent"], rtol=1e-6, atol=0)
    assert np.max(np.abs(got["test_loss"] - want["test_loss"])) <= 1e-4
    assert np.max(np.abs(got["test_acc"] - want["test_acc"])) \
        <= 1.0 / n_test + 1e-9


def small_spec(cls):
    mod = jsweep if cls is jhsfl.HSFLConfig else tsweep
    return mod.SweepSpec(base=tiny(cls), seeds=(0, 1),
                         schemes=(("opt", {"b": 2.0}), ("async", {"b": 1.0})))


def codec_spec(cls):
    mod = jsweep if cls is jhsfl.HSFLConfig else tsweep
    return mod.SweepSpec(base=tiny(cls, rounds=3, local_epochs=6,
                                   use_delta_codec=True),
                         seeds=(0,),
                         schemes=(("opt", {"b": 2.0}), ("async", {"b": 1.0}),
                                  ("discard", {"b": 1.0})))


@pytest.fixture(scope="module")
def codec_panel():
    spec = codec_spec(HSFLConfig)
    return spec, tsweep._run_sweep(spec, device="cpu",
                                   stream_factory=replay_factory)


@pytest.mark.parametrize("panel", ["small", "codec"])
def test_sweep_matches_jax(panel, codec_panel):
    make = small_spec if panel == "small" else codec_spec
    want = jsweep._run_sweep(make(jhsfl.HSFLConfig), mesh=None)
    got = (codec_panel[1] if panel == "codec" else tsweep._run_sweep(
        make(HSFLConfig), device="cpu", stream_factory=replay_factory))
    assert got.n_programs == want.n_programs
    assert got.n_simulations == want.n_simulations
    for g, w in zip(got.groups, want.groups):
        assert (g.scheme, g.label, g.program_id, g.sims, g.cfgs) == \
            (w.scheme, w.label, w.program_id, w.sims, w.cfgs)
        assert_metrics_match(g.metrics, w.metrics, 100)
    if panel == "codec":
        assert sum(g.metrics["rescued"].sum() for g in got.groups) > 0, \
            "fixture no longer rescues"


def test_codec_panel_is_two_programs(codec_panel):
    spec, res = codec_panel
    assert res.n_programs == 2
    assert [g.program_id for g in res.groups] == [0, 1, 0]
    assert [g.label for g in res.groups] == ["opt+codec", "async+codec",
                                             "discard+codec"]
    assert all(g.metrics["test_acc"].shape == (1, 1, 3) for g in res.groups)


def test_lowered_discard_equals_dedicated_discard(codec_panel):
    spec, res = codec_panel
    ref = tsweep._run_sweep(spec, device="cpu", lower_discard=False,
                            stream_factory=replay_factory)
    assert ref.n_programs == 3
    got = next(g for g in res.groups if g.scheme == "discard")
    want = next(g for g in ref.groups if g.scheme == "discard")
    for key in want.metrics:
        np.testing.assert_array_equal(got.metrics[key], want.metrics[key],
                                      err_msg=key)


# -- the port's own contracts, on its default streams -------------------------

def run_group(spec, stream_factory=None):
    """(metrics, final params (S, C) grid of numpy trees) of the spec's
    first group, through the engine's own pieces."""
    group = tsweep.compile_spec(spec)[0]
    data = tsweep._sim_tensors(tsweep._stack_sims(group), "cpu")
    kw = {} if stream_factory is None else {"stream_factory": stream_factory}
    carry, streams, cfg = tsweep._group_inputs(group, data, "cpu", **kw)
    fn = tsweep.build_device_round(**tsweep._group_build_kwargs(group))
    carry, per_round = tsweep._scan_rounds(fn, carry, streams, data, cfg,
                                           spec.base.rounds)
    s, c = len(group.sims), len(group.cfgs)
    params = params_to_numpy(carry.params)
    grid = [[tree_map(lambda a: a[i * c + j], params) for j in range(c)]
            for i in range(s)]
    return tsweep._read_metrics(per_round, s, c), grid


def leaves(tree):
    return [tree[k][n] for k in sorted(tree) for n in sorted(tree[k])]


def test_sweep_is_deterministic():
    spec = small_spec(HSFLConfig)
    a = tsweep._run_sweep(spec, device="cpu")
    b = tsweep._run_sweep(spec, device="cpu", timeit=True)
    for g1, g2 in zip(a.groups, b.groups):
        for key in g1.metrics:
            np.testing.assert_array_equal(g1.metrics[key], g2.metrics[key])
        assert g2.run_s > 0


def test_row_does_not_depend_on_its_group():
    """Seed 1's row of a (0, 1) group equals seed 1 run alone, bit for
    bit: each simulation draws only from its own stream."""
    base = tiny(rounds=3, local_epochs=6, use_delta_codec=True)
    both, pb = run_group(tsweep.SweepSpec(base=base, seeds=(0, 1), b=(2.0,)))
    alone, pa = run_group(tsweep.SweepSpec(base=base, seeds=(1,), b=(2.0,)))
    for key in COUNTS + ("bytes_sent",):
        np.testing.assert_array_equal(both[key][1], alone[key][0], key)
    assert np.abs(both["test_loss"][1] - alone["test_loss"][0]).max() <= 1e-6
    assert np.abs(both["test_acc"][1] - alone["test_acc"][0]).max() \
        <= 1.0 / base.n_test + 1e-9
    for x, y in zip(leaves(pb[1][0]), leaves(pa[0][0])):
        np.testing.assert_array_equal(x, y)


def test_folded_configs_equal_each_config_alone():
    base = tiny(rounds=3, local_epochs=6)
    bs = (1.0, 2.0, 3.0)
    folded, pf = run_group(tsweep.SweepSpec(base=base, seeds=(1,), b=bs))
    assert folded["rescued"][0, 0].sum() == 0      # b=1: no snapshots
    assert folded["rescued"][0, 1:].sum() > 0, "fixture never rescues"
    for c, b in enumerate(bs):
        alone, pa = run_group(tsweep.SweepSpec(base=base, seeds=(1,),
                                               b=(b,)))
        for key in COUNTS:
            np.testing.assert_array_equal(folded[key][0, c], alone[key][0, 0])
        for x, y in zip(leaves(pf[0][c]), leaves(pa[0][0])):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def test_default_stream_indices_stay_below_clen():
    st = TorchStream(3, "cpu")
    clen = torch.tensor([[1, 2, 7], [300, 5, 1]])
    idx = st.batch_indices(1, 1, clen, 4000)
    assert idx.shape == (2, 3, 4000) and idx.dtype == torch.int64
    assert bool((idx >= 0).all()) and bool((idx < clen[..., None]).all())
    assert idx[1, 0].unique().numel() > 250


@pytest.mark.parametrize("overlap", [True, False])
def test_run_sweep_takes_overlap_compile(overlap):
    """The reference's ``overlap_compile`` argument, taken by both entry
    points with no effect: there is no compile to overlap."""
    spec = tsweep.SweepSpec(base=tiny(rounds=1), seeds=(0,), b=(2.0,))
    want = tsweep._run_sweep(spec, device="cpu")
    got = tsweep._run_sweep(spec, device="cpu", overlap_compile=overlap)
    with pytest.warns(DeprecationWarning):
        shim = tsweep.run_sweep(spec, device="cpu", overlap_compile=overlap)
    for res in (got, shim):
        for key in want.groups[0].metrics:
            np.testing.assert_array_equal(res.groups[0].metrics[key],
                                          want.groups[0].metrics[key])


# -- the group's simulation arrays ---------------------------------------------

def stacked_serially(build, group, m):
    """Each simulation's ``build(cfg, pad_len=m)``, one after another,
    stacked."""
    per_sim = [build(replace(group.base, seed=seed, distribution=dist),
                     pad_len=m)
               for seed, dist in group.sims]
    return {k: np.stack([a[k] for a in per_sim]) for k in per_sim[0]}


def assert_arrays_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dist", ["noniid", "imbalanced"])
def test_stack_sims_equals_the_serial_build(dist):
    """Clients' lengths differ within and across simulations, so the
    padding to the group's longest client engages."""
    spec = tsweep.SweepSpec(base=tiny(distribution=dist), seeds=(0, 1, 2, 3),
                            b=(1.0, 2.0))
    group = tsweep.compile_spec(spec)[0]
    with trace.record() as rec:
        got = tsweep._stack_sims(group)
    lens = got["client_len"]
    m = got["client_x"].shape[2]
    assert m == lens.max() and len(np.unique(lens)) > 1
    assert_arrays_equal(got, stacked_serially(tsweep.build_sim_arrays,
                                              group, m))
    on_pool = 4 if len(os.sched_getaffinity(0)) > 1 else 0
    assert rec.counters == {"sweep.sims_built": 4,
                            "sweep.sims_built_concurrently": on_pool}


def test_one_simulation_is_built_in_the_calling_thread(monkeypatch):
    group = tsweep.compile_spec(tsweep.SweepSpec(base=tiny(), seeds=(5,)))[0]
    monkeypatch.setattr(tsweep, "_pool", None)      # a pool call would raise
    with trace.record() as rec:
        got = tsweep._stack_sims(group)
    assert rec.counters == {"sweep.sims_built": 1,
                            "sweep.sims_built_concurrently": 0}
    assert_arrays_equal(got, stacked_serially(
        tsweep.build_sim_arrays, group, got["client_x"].shape[2]))


@pytest.mark.parametrize("dist", ["iid", "noniid", "imbalanced"])
def test_stack_sims_equals_the_reference_at_the_papers_size(dist):
    """30 UAVs, 6000 training and 1000 test images a simulation."""
    cfg = HSFLConfig(distribution=dist)
    assert (cfg.n_uavs, cfg.n_train, cfg.n_test) == (30, 6000, 1000)
    group = tsweep.compile_spec(tsweep.SweepSpec(base=cfg,
                                                 seeds=(7, 8, 9)))[0]
    got = tsweep._stack_sims(group)
    m = got["client_x"].shape[2]
    jgroup = jsweep.compile_spec(jsweep.SweepSpec(
        base=jhsfl.HSFLConfig(distribution=dist), seeds=(7, 8, 9)))[0]
    assert_arrays_equal(got, stacked_serially(jhsfl.build_sim_arrays,
                                              jgroup, m))
