"""The port's control plane against the JAX package's.

The data, channel, selection, latency and schedule modules of the port are
numpy copies: for the same seeds they must give array-equal results.  The
scheme registry is a translation: all 8 registered schemes' aggregates run
on the same random stacked inputs (invalid slots included) in both
packages.  Aggregates sum over the K axis in another order than XLA, so
params agree to ``rtol=1e-5, atol=1e-6``; masks and counts are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jchan  # noqa: E402
from repro.core import hsfl as jhsfl  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import schemes as jsch  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import transmission as jtx  # noqa: E402
from repro.core.opportunistic_sync import snapshot_decision as j_snap  # noqa: E402
from repro.data.partition import partition as j_partition  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import channel as tchan  # noqa: E402
from repro_torch.core import hsfl as thsfl  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import schemes as tsch  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import transmission as ttx  # noqa: E402
from repro_torch.core.opportunistic_sync import snapshot_decision as t_snap  # noqa: E402
from repro_torch.data.partition import partition as t_partition  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

torch.set_num_threads(1)

SEEDS = [0, 1, 2]
SCHEMES = sorted(jsch.registered_schemes())


@pytest.mark.parametrize("seed", SEEDS)
def test_data_copies_are_array_equal(seed):
    a, b = jsyn.make_digits(300, seed=seed), tsyn.make_digits(300, seed=seed)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    for dist in ("iid", "noniid", "imbalanced"):
        pa = j_partition(a, 7, dist, seed)
        pb = t_partition(b, 7, dist, seed)
        assert len(pa) == len(pb)
        for ca, cb in zip(pa, pb):
            np.testing.assert_array_equal(ca.x, cb.x)
            np.testing.assert_array_equal(ca.y, cb.y)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 7000])
def test_make_digits_is_array_equal(n, seed):
    """The port draws a set's noise as one array, the reference image by
    image: the same images, labels and dtypes, up to the paper's 7000."""
    a, b = jsyn.make_digits(n, seed=seed), tsyn.make_digits(n, seed=seed)
    assert (b.x.dtype, b.y.dtype) == (a.x.dtype, a.y.dtype)
    assert b.x.shape == a.x.shape == (n, 28, 28, 1)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_stream_is_array_equal(seed):
    fa, fb = jchan.UAVFleet(12, seed=seed), tchan.UAVFleet(12, seed=seed)
    for _ in range(4):
        fa.resample_fading(), fb.resample_fading()
        for _ in range(3):
            fa.move(), fb.move()
            np.testing.assert_array_equal(fa.rates(), fb.rates())
            np.testing.assert_array_equal(fa.outages(), fb.outages())
        np.testing.assert_array_equal(fa.rates(0.5), fb.rates(0.5))
    np.testing.assert_array_equal(fa.pos, fb.pos)


@pytest.mark.parametrize("seed", SEEDS)
def test_selection_and_latency_copies_agree(seed):
    rng = np.random.default_rng(seed)
    n = 20
    rates0 = rng.uniform(1e6, 6e7, n)
    flops = rng.uniform(0.8e8, 4e8, n)
    samples = rng.integers(50, 400, n)
    outs = []
    for lat, sel in ((jlat, jsel), (tlat, tsel)):
        devs = [lat.DeviceProfile(flops_per_sec=float(f)) for f in flops]
        wls = [lat.WorkloadProfile(samples=int(s)) for s in samples]
        sched = sel.schedule_users(rates0, devs, wls, 10e6, 2.5e6, 2, 9.0,
                                   8)
        vec = sel.user_latency_energy(
            rates0, flops, samples.astype(np.float64), b=2,
            model_bytes=10e6, ue_model_bytes=2.5e6, local_epochs=6)
        scalars = [(lat.train_time_fl(d, w), lat.train_time_sl(d, w),
                    lat.extra_allowance(2, 10e6, r), lat.snapshot_delay(1e6, r))
                   for d, w, r in zip(devs, wls, rates0)]
        outs.append(([dataclasses.astuple(u) for u in sched], vec, scalars))
    (sa, va, la), (sb, vb, lb) = outs
    assert sa == sb and len(sa) > 0
    for x, y in zip(va, vb):
        np.testing.assert_array_equal(x, y)
    assert la == lb


def test_schedule_functions_agree():
    for e in range(1, 9):
        for b in range(0, 7):
            assert jtx.scheduled_epochs(e, b) == ttx.scheduled_epochs(e, b)
            if b:
                assert jtx.schedule_period(e, b) == ttx.schedule_period(e, b)
            for e_t in range(0, e + 1):
                want = bool(jsch.probe_schedule_mask(e_t, e, float(b)))
                got = bool(tsch.probe_schedule_mask(e_t, e, float(b)))
                assert want == got, (e, b, e_t)
            for name in SCHEMES:
                assert (jsch.get_scheme(name).static_schedule(e, b)
                        == tsch.get_scheme(name).static_schedule(e, b))


def test_registry_and_config_carry_over():
    assert tsch.registered_schemes() == jsch.registered_schemes()
    for name in SCHEMES:
        js, ts = jsch.get_scheme(name), tsch.get_scheme(name)
        for fact in ("uses_probes", "carries_delayed", "supports_codec"):
            assert getattr(js, fact) == getattr(ts, fact), (name, fact)
    with pytest.raises(ValueError, match="registered schemes"):
        tsch.get_scheme("nope")
    # same config fields and defaults: a JAX config carries over
    jf = {f.name: f.default for f in dataclasses.fields(jhsfl.HSFLConfig)
          if f.default is not dataclasses.MISSING}
    tf = {f.name: f.default for f in dataclasses.fields(thsfl.HSFLConfig)
          if f.default is not dataclasses.MISSING}
    assert jf == tf
    assert [f.name for f in dataclasses.fields(jhsfl.HSFLConfig)] == \
        [f.name for f in dataclasses.fields(thsfl.HSFLConfig)]


def test_snapshot_decision_agrees():
    rng = np.random.default_rng(0)
    sched = rng.random(64) < 0.7
    outage = rng.random(64) < 0.3
    tau = rng.uniform(0, 2, 64).astype(np.float32)
    extra = rng.uniform(0, 2, 64).astype(np.float32)
    ok_j, ex_j = j_snap(jnp.asarray(sched), jnp.asarray(outage),
                        jnp.asarray(tau), jnp.asarray(extra))
    ok_t, ex_t = t_snap(torch.tensor(sched), torch.tensor(outage),
                        torch.tensor(tau), torch.tensor(extra))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    np.testing.assert_array_equal(np.asarray(ex_j), ex_t.numpy())


def _tree(rng, lead=()):
    return {"a": {"w": rng.standard_normal(lead + (3, 4)).astype(np.float32),
                  "b": rng.standard_normal(lead + (4,)).astype(np.float32)},
            "c": {"w": rng.standard_normal(lead + (5,)).astype(np.float32)}}


def _close_trees(got, want):
    got = params_to_numpy(got)
    want = jax.tree_util.tree_map(np.asarray, want)
    for k in want:
        for leaf in want[k]:
            np.testing.assert_allclose(got[k][leaf], want[k][leaf],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k}.{leaf}")


# each case: (arrived, has_snap, delayed_mask) over K=6 slots; slot 5 is an
# invalid padded slot in the first cases
MASKS = [
    ([1, 0, 1, 0, 1, 0], [0, 1, 1, 0, 0, 0], [1, 0, 0, 1, 0, 0]),
    ([0, 0, 0, 0, 0, 0], [0, 1, 0, 1, 1, 0], [0, 1, 0, 0, 0, 0]),
    ([0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]),
    ([1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]),
]


@pytest.mark.parametrize("case", range(len(MASKS)))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_aggregate_agrees(scheme, case):
    rng = np.random.default_rng(case)
    k = 6
    params = _tree(rng)
    contribs = _tree(rng, (k,))
    snaps = _tree(rng, (k,))
    delayed = _tree(rng, (k,))
    arrived, has_snap, dmask = (np.asarray(m, bool) for m in MASKS[case])
    aw = 0.4 * 2.0 ** -0.5
    js, ts = jsch.get_scheme(scheme), tsch.get_scheme(scheme)
    jnew, jres = js.aggregate(
        params, contribs, snaps, jnp.asarray(has_snap), jnp.asarray(arrived),
        delayed=delayed, delayed_mask=jnp.asarray(dmask), async_weight=aw,
        k_carry=k)
    tp = lambda t: params_from_numpy(t, "cpu")
    tnew, tres = ts.aggregate(
        tp(params), tp(contribs), tp(snaps), torch.tensor(has_snap),
        torch.tensor(arrived), delayed=tp(delayed),
        delayed_mask=torch.tensor(dmask), async_weight=aw, k_carry=k)
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    _close_trees(tnew, jnew)
    np.testing.assert_array_equal(
        np.asarray(js.delayed_out(jnp.asarray(arrived | has_snap),
                                  jnp.asarray(arrived))),
        ts.delayed_out(torch.tensor(arrived | has_snap),
                       torch.tensor(arrived)).numpy())
    np.testing.assert_array_equal(
        np.asarray(js.final_slack(jnp.asarray([1.5, 2.0], jnp.float32))),
        ts.final_slack(torch.tensor([1.5, 2.0])).numpy())


@pytest.mark.parametrize("n_arrived,n_delayed", [(3, 2), (0, 2), (0, 0),
                                                 (1, 0)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_aggregate_host_agrees(scheme, n_arrived, n_delayed):
    rng = np.random.default_rng(n_arrived * 7 + n_delayed)
    params = _tree(rng)
    arrived = [_tree(rng) for _ in range(n_arrived)]
    delayed = [(_tree(rng), 1) for _ in range(n_delayed)]
    want = jsch.get_scheme(scheme).aggregate_host(arrived, delayed, params)
    tp = lambda t: params_from_numpy(t, "cpu")
    got = tsch.get_scheme(scheme).aggregate_host(
        [tp(a) for a in arrived], [(tp(d), s) for d, s in delayed],
        tp(params))
    _close_trees(got, want)
