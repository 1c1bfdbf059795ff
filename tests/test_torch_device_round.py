"""The port's on-device round against the JAX package's, on the same draws.

torch cannot make ``jax.random``'s numbers, so ``JaxReplay`` (a
``streams.SimStream``) replays the reference's key discipline for one
simulation: the params of ``init_cnn(PRNGKey(seed))``, the fleet key
``PRNGKey(seed + 1)`` split six ways by ``fleet_init`` and once per fading
resample, move and outage step, and the batch indices of
``randint(fold_in(rkey, e_t), (K, steps·B), 0, clen)`` with the round keys
``split(fold_in(PRNGKey(seed), 2), rounds)``.  Both packages then run on
the same draws and the same initial params.  Tolerances:

- ``FleetState``: ``bad`` exactly equal; positions and Rician K within
  rel 1e-6; rates within rel 3e-6.  The rate is 10^(pl/10) of a path
  loss pl near -90 dB in f32: one ulp of pl/10 is 2.2e-6 of the gain,
  and the two libraries' f32 log10, exp and arcsin put pl 1–2 ulps apart,
  so the rates of both packages are up to 8e-7 off the f64 value and up
  to 1.5e-6 apart (measured over 20 fleets); 1e-6 is below that floor.
- ``select_users_device``: picks and modes exactly equal to
  ``select_users_jax`` and to the host greedy ``schedule_users``.
- ``probe_schedule`` over a batch of budgets: exactly
  ``scheduled_epochs``.
- ``build_sim_arrays``: bitwise.
- the stacked eval forward: within 1e-5 of the largest logit of the JAX
  eval forward at f32 (summation order), 2 bf16 ulps (2**-6) at bf16.
- ``build_device_round`` against the reference's (jitted on the CPU,
  Pallas in interpret mode) over 3 rounds for opt (b=3, a fixture that
  rescues), async, discard and opt with the codec: selected, arrived,
  rescued, delayed and dropped exactly equal each round; bytes_sent within
  rel 1e-6; params within 1e-4 (max abs); test loss within 1e-4; accuracy
  within one test image.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import channel_lib as jcl  # noqa: E402
from repro.core import hsfl as jhsfl  # noqa: E402
from repro.core.fused_round import DeviceSimCarry as JCarry  # noqa: E402
from repro.core.fused_round import build_device_round as j_build  # noqa: E402
from repro.core.selection import select_users_jax  # noqa: E402
from repro.core.transmission import scheduled_epochs  # noqa: E402
from repro.kernels.fused_cnn.ops import ForwardPolicy as JPolicy  # noqa: E402
from repro.kernels.fused_cnn.ops import (  # noqa: E402
    make_eval_forward as j_eval)
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.core import channel_lib as tcl  # noqa: E402
from repro_torch.core import hsfl as thsfl  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core.fused_round import build_device_round  # noqa: E402
from repro_torch.core.schemes import get_scheme  # noqa: E402
from repro_torch.core.selection import (schedule_users,  # noqa: E402
                                        select_users_device)
from repro_torch.core.streams import GroupStream, SimStream  # noqa: E402
from repro_torch.core.sweep import (  # noqa: E402
    SweepSpec, _group_build_kwargs, _group_inputs, _read_metrics,
    _sim_tensors, _stack_sims, compile_spec)
from repro_torch.kernels.fused_cnn.ops import (ForwardPolicy,  # noqa: E402
                                               make_stacked_eval_forward)

torch.set_num_threads(1)


class JaxReplay(SimStream):
    """The reference's draws for the simulation of ``cfg`` (its seed and
    rounds), as CPU tensors; ``batch_indices`` asks ``jax.random.randint``
    with the port's clen."""

    def __init__(self, cfg, device="cpu"):
        self.device = torch.device(device)
        self.seed = cfg.seed
        self.fkey = jax.random.PRNGKey(cfg.seed + 1)
        self.rkeys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 2), cfg.rounds)

    def _t(self, a):
        return torch.from_numpy(np.array(a)).to(self.device)

    def init_params(self):
        p = jcnn.init_cnn(jax.random.PRNGKey(self.seed))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                 self.device)

    def fleet_init_draws(self, n, p):
        kr, ka, kz, kk, kb, self.fkey = jax.random.split(self.fkey, 6)
        u = jax.random.uniform
        return tuple(self._t(a) for a in (
            u(kr, (n,)), u(ka, (n,)),
            u(kz, (n,), minval=p.uav_z_range[0], maxval=p.uav_z_range[1]),
            u(kk, (n,), minval=p.k_db_range[0], maxval=p.k_db_range[1]),
            u(kb, (n,))))

    def fleet_uniform(self, n, lo=0.0, hi=1.0):
        k, self.fkey = jax.random.split(self.fkey)
        return self._t(jax.random.uniform(k, (n,), minval=lo, maxval=hi))

    def fleet_normal(self, shape):
        k, self.fkey = jax.random.split(self.fkey)
        return self._t(jax.random.normal(k, tuple(shape)))

    def batch_indices(self, round_t, e_t, clen, n):
        key = jax.random.fold_in(self.rkeys[round_t - 1], e_t)
        cl = clen.cpu().numpy().astype(np.int32)
        out = [np.asarray(jax.random.randint(
            key, (cl.shape[1], n), 0, jnp.asarray(row)[:, None]))
            for row in cl]
        return torch.from_numpy(np.stack(out).astype(np.int64)).to(
            self.device)


def replay_factory(cfg, device):
    return JaxReplay(cfg, device)


def tiny(cls, **kw):
    base = dict(rounds=3, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=6, seed=1)
    base.update(kw)
    return cls(**base)


def rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# -- FleetState ---------------------------------------------------------------

RATE_RTOL = 3e-6    # the f32 floor of eq. (7) across two libraries (above)


def test_fleet_state_ops_match_jax():
    p = tcl.ChannelParams()
    n = 30
    jstate = jcl.fleet_init(jax.random.PRNGKey(7), n, p)
    rep = JaxReplay(tiny(thsfl.HSFLConfig, seed=6))
    tstate = tcl.fleet_init(rep.fleet_init_draws(n, p), p)

    def same(js, ts, bws=(1.0, 0.5)):
        np.testing.assert_array_equal(np.asarray(js.bad),
                                      ts.bad.numpy())
        rel_close(ts.pos.numpy(), js.pos, 1e-6)
        rel_close(ts.k_db.numpy(), js.k_db, 1e-6)
        for bw in bws:
            rel_close(tcl.fleet_rates(ts, p, torch.tensor(bw)).numpy(),
                      jax.jit(lambda s: jcl.fleet_rates(
                          s, p, jnp.float32(bw)))(js), RATE_RTOL)

    same(jstate, tstate)
    flips = 0
    for step in range(6):
        jstate = jcl.fleet_resample_fading(jstate, p)
        tstate = tcl.fleet_resample_fading(
            tstate, rep.fleet_uniform(n, *p.k_db_range))
        for _ in range(3):
            jstate = jcl.fleet_move(jstate, p, 15.0, 1.0)
            tstate = tcl.fleet_move(tstate, p, 15.0, 1.0,
                                    rep.fleet_normal((n, 3)))
            before = tstate.bad
            jstate, jbad = jcl.fleet_outage_step(jstate, p)
            tstate, tbad = tcl.fleet_outage_step(tstate, p,
                                                 rep.fleet_uniform(n))
            np.testing.assert_array_equal(np.asarray(jbad), tbad.numpy())
            flips += int((before != tbad).sum())
        same(jstate, tstate)
    assert flips > 0, "the outage chain never moved"


def test_torch_equations_are_the_numpy_ones_in_f32():
    """eqs. (1)-(7) with ``xp=torch`` on f32 tensors follow the host's f64
    numpy ones."""
    p = tcl.ChannelParams()
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(-500, 500, 50), rng.uniform(-500, 500, 50),
                    rng.uniform(20, 80, 50)], -1)
    k_db = rng.uniform(1.8, 5.0, 50)
    want = tcl.rate_bps(pos, k_db, p)
    got = tcl.rate_bps(torch.tensor(pos, dtype=torch.float32),
                       torch.tensor(k_db, dtype=torch.float32), p,
                       torch.tensor(1.0), xp=torch).numpy()
    rel_close(got, want, 1e-5)


# -- selection ----------------------------------------------------------------

def _trial(rng):
    n = int(rng.integers(3, 25))
    k = int(rng.integers(2, 9))
    b = int(rng.integers(1, 5))
    tau = float(rng.uniform(6, 12))
    rates0 = rng.uniform(1e6, 1e8, n)
    flops = rng.uniform(0.8e8, 4e8, n)
    samples = rng.integers(50, 400, n)
    return n, k, b, tau, rates0, flops, samples


def test_select_users_device_matches_jax_and_host():
    rng = np.random.default_rng(0)
    for trial in range(12):
        n, k, b, tau, rates0, flops, samples = _trial(rng)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        kw = dict(k_select=k, model_bytes=10e6, ue_model_bytes=2.5e6,
                  local_epochs=6)
        jsel, jmode, jvalid, jn, _, _ = select_users_jax(
            jnp.asarray(f32(rates0)), jnp.asarray(f32(flops)),
            jnp.asarray(f32(samples)), b=jnp.float32(b),
            tau_max=jnp.float32(tau), **kw)
        sel, mode, valid, n_taken, _, _ = select_users_device(
            torch.tensor(f32(rates0)), torch.tensor(f32(flops)),
            torch.tensor(f32(samples)), b=float(b), tau_max=tau, **kw)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(mode.numpy(), np.asarray(jmode))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert int(n_taken) == int(jn)
        devices = [tlat.DeviceProfile(flops_per_sec=float(f)) for f in flops]
        wls = [tlat.WorkloadProfile(local_epochs=6, samples=int(s))
               for s in samples]
        host = schedule_users(rates0, devices, wls, 10e6, 2.5e6, b, tau, k)
        got = [(int(sel[j]), "SL" if bool(mode[j]) else "FL")
               for j in range(k) if bool(valid[j])]
        assert got == [(u.index, u.mode) for u in host], trial


def test_select_users_device_batched_rows_match_jax():
    """One call over G rows with their own rates, b and τ_max gives each
    row what ``select_users_jax`` gives it alone."""
    rng = np.random.default_rng(5)
    g, n, k = 9, 20, 6
    rates0 = rng.uniform(1e6, 1e8, (g, n)).astype(np.float32)
    flops = np.tile(rng.uniform(0.8e8, 4e8, n), (g, 1)).astype(np.float32)
    samples = np.tile(rng.integers(50, 400, n), (g, 1)).astype(np.float32)
    b = rng.integers(1, 5, g).astype(np.float32)
    tau = rng.uniform(6, 12, g).astype(np.float32)
    kw = dict(k_select=k, model_bytes=10e6, ue_model_bytes=2.5e6,
              local_epochs=6)
    out = select_users_device(torch.tensor(rates0), torch.tensor(flops),
                              torch.tensor(samples), b=torch.tensor(b),
                              tau_max=torch.tensor(tau), **kw)
    taken = 0
    for r in range(g):
        want = select_users_jax(jnp.asarray(rates0[r]), jnp.asarray(flops[r]),
                                jnp.asarray(samples[r]), b=jnp.float32(b[r]),
                                tau_max=jnp.float32(tau[r]), **kw)
        for got_a, want_a in zip(out[:4], want[:4]):
            np.testing.assert_array_equal(got_a[r].numpy(),
                                          np.asarray(want_a))
        for got_a, want_a in zip(out[4:], want[4:]):
            rel_close(got_a[r].numpy(), want_a, 1e-6)
        taken += int(want[3])
    assert 0 < taken < g * k, "fixture selects all or nothing"


def test_probe_schedule_batched_matches_scheduled_epochs():
    opt = get_scheme("opt")
    for e in (2, 3, 4, 6, 8, 12):
        bs = torch.arange(1, 9, dtype=torch.float32)
        masks = torch.stack([opt.probe_schedule(e_t, e, bs)
                             for e_t in range(1, e + 1)], dim=1)  # (8, e)
        for row, b in enumerate(range(1, 9)):
            got = {e_t for e_t in range(1, e + 1) if bool(masks[row, e_t - 1])}
            assert got == set(scheduled_epochs(e, b)), (e, b, got)
    for e_t in range(1, 7):
        m = opt.probe_schedule(e_t, 6, torch.ones(3), override=(2, 5))
        assert m.shape == (3,) and bool(m.all()) == (e_t in (2, 5))
        assert not bool(get_scheme("async").probe_schedule(
            e_t, 6, torch.full((3,), 3.0)).any())


# -- sim arrays, eval ---------------------------------------------------------

@pytest.mark.parametrize("dist", ["iid", "noniid", "imbalanced"])
def test_build_sim_arrays_bitwise(dist):
    for pad in (None, 301):
        kw = dict(n_uavs=7, n_train=500, n_test=60, seed=2,
                  distribution=dist)
        want = jhsfl.build_sim_arrays(jhsfl.HSFLConfig(**kw), pad_len=pad)
        got = thsfl.build_sim_arrays(thsfl.HSFLConfig(**kw), pad_len=pad)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_stacked_eval_forward_matches_jax(precision):
    """G = 3 models, each on its own 40 test images, at K = G."""
    rng = np.random.default_rng(4)
    trees = [jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(i))) for i in range(3)]
    images = rng.uniform(0, 1, (3, 40, 28, 28, 1)).astype(np.float32)
    jfwd = j_eval(JPolicy(precision=precision))
    want = np.stack([np.asarray(jfwd(trees[g], jnp.asarray(images[g])))
                     for g in range(3)])
    stacked = params_from_numpy(
        jax.tree_util.tree_map(lambda *ls: np.stack(ls), *trees), "cpu")
    got = make_stacked_eval_forward(ForwardPolicy(precision=precision))(
        stacked, torch.tensor(images)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 40, 10)
    tol = 1e-5 if precision == "f32" else 2 ** -6
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))
    # the per-model path ("im2col" and batch_users=False) agrees as well
    each = make_stacked_eval_forward(ForwardPolicy(
        precision=precision, batch_users=False))(
            stacked, torch.tensor(images)).numpy()
    assert np.max(np.abs(each - want)) <= tol * np.max(np.abs(want))


# -- the device round ---------------------------------------------------------

CASES = {"opt": dict(scheme="opt", b=3), "async": dict(scheme="async", b=1),
         "discard": dict(scheme="discard", b=1),
         "opt+codec": dict(scheme="opt", b=3, use_delta_codec=True)}


def _jax_rounds(cfg, forward=None):
    """The reference round, jitted, over cfg.rounds rounds."""
    sim = {k: jnp.asarray(v) for k, v in jhsfl.build_sim_arrays(cfg).items()}
    params0 = jcnn.init_cnn(jax.random.PRNGKey(cfg.seed))
    fleet0 = jcl.fleet_init(jax.random.PRNGKey(cfg.seed + 1), cfg.n_uavs,
                            cfg.channel)
    rkeys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 2), cfg.rounds)
    k = cfg.k_select
    zstack = jax.tree_util.tree_map(
        lambda a: jnp.zeros((k,) + a.shape, a.dtype), params0)
    carry = JCarry(params0, fleet0, zstack, jnp.zeros((k,), bool))
    rf = jax.jit(j_build(
        scheme=cfg.scheme, local_epochs=cfg.local_epochs,
        steps_per_epoch=cfg.steps_per_epoch, batch_size=cfg.batch_size,
        lr=cfg.lr, k_select=k, channel=cfg.channel,
        model_bytes=cfg.model_bytes,
        ue_model_fraction=cfg.ue_model_fraction,
        compress_ratio=jhsfl.model_compress_ratio(cfg),
        use_codec=cfg.use_delta_codec, interpret=True, forward=forward))
    cfgv = {"b": jnp.float32(cfg.b), "tau_max": jnp.float32(cfg.tau_max),
            "bandwidth_ratio": jnp.float32(1.0)}
    rows = []
    for t in range(cfg.rounds):
        carry, m = rf(carry, rkeys[t], sim, cfgv)
        rows.append(jax.tree_util.tree_map(np.asarray, m._asdict()))
    return rows, jax.tree_util.tree_map(np.asarray, carry.params)


def _port_rounds(cfg, forward=None):
    """The port's round on the replayed draws, one simulation, one config
    (``forward``: the group's policy unless given)."""
    group = compile_spec(SweepSpec(base=cfg, seeds=(cfg.seed,)))[0]
    data = _sim_tensors(_stack_sims(group), "cpu")
    carry, streams, cfgv = _group_inputs(group, data, "cpu", replay_factory)
    assert isinstance(streams, GroupStream)
    kw = _group_build_kwargs(group)
    rf = build_device_round(**{**kw, "forward": forward or kw["forward"]})
    per_round = []
    for t in range(1, cfg.rounds + 1):
        carry, m = rf(carry, t, streams, data, cfgv)
        per_round.append(m)
    metrics = _read_metrics(per_round, 1, 1)
    rows = [{k: v[0, 0, t] for k, v in metrics.items()}
            for t in range(cfg.rounds)]
    params = params_to_numpy(carry.params)
    return rows, jax.tree_util.tree_map(lambda a: a[0], params)


COUNTS = ("selected", "arrived", "rescued", "delayed", "dropped")


def assert_rounds_match(got, want, n_test):
    for t, (g, w) in enumerate(zip(got, want)):
        assert [int(g[c]) for c in COUNTS] == [int(w[c]) for c in COUNTS], \
            (t, g, w)
        rel_close(g["bytes_sent"], w["bytes_sent"], 1e-6)
        assert abs(float(g["test_loss"]) - float(w["test_loss"])) <= 1e-4
        assert abs(float(g["test_acc"]) - float(w["test_acc"])) \
            <= 1.0 / n_test + 1e-9


def assert_params_close(got, want, atol=1e-4):
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       rtol=0, atol=atol,
                                       err_msg=f"{layer}.{leaf}")


@pytest.mark.parametrize("case", list(CASES))
def test_device_round_matches_jax(case):
    kw = CASES[case]
    jcfg, tcfg = tiny(jhsfl.HSFLConfig, **kw), tiny(thsfl.HSFLConfig, **kw)
    want, jparams = _jax_rounds(jcfg)
    got, tparams = _port_rounds(tcfg)
    assert_rounds_match(got, want, tcfg.n_test)
    assert_params_close(tparams, jparams)
    if case.startswith("opt"):
        assert sum(int(r["rescued"]) for r in got) > 0, \
            "fixture no longer rescues"
    if case == "async":
        assert sum(int(r["delayed"]) for r in got) > 0, \
            "fixture never delays"
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_device_round_takes_a_bare_forward_callable():
    """As the reference's ``_resolve_epoch_fns`` and the port's
    ``build_fused_round``: a bare ``forward(params, x) -> logits`` trains
    by autograd and evaluates each row's model; the counts equal the
    reference's with its own bare forward, over the same draws."""
    from repro_torch.models import cnn as tcnn
    kw = CASES["opt"]
    jcfg, tcfg = tiny(jhsfl.HSFLConfig, **kw), tiny(thsfl.HSFLConfig, **kw)
    want, jparams = _jax_rounds(jcfg, forward=jcnn.forward)
    got, tparams = _port_rounds(tcfg, forward=tcnn.forward)
    assert_rounds_match(got, want, tcfg.n_test)
    assert_params_close(tparams, jparams)
    group = compile_spec(SweepSpec(base=tcfg, seeds=(tcfg.seed,)))[0]
    with pytest.raises(TypeError, match="forward must be a ForwardPolicy"):
        build_device_round(**{**_group_build_kwargs(group),
                              "forward": "xla"})
