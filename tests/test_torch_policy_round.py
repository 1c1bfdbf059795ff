"""The port's fused HSFL round under every forward policy, and its two
repairs, on the CPU against the JAX fused engine.

Both packages run the same configuration (``tests/test_torch_hsfl.py``'s:
8 UAVs, K=4, 3 epochs of 2 steps, batch 10, 2 rounds) from the same
initial params.  The control plane decides from the same numpy streams, so
the per-round counts must be equal; accuracy agrees within 3 test images
of 100 and params as follows (measured gaps in brackets):

- f32 policies (single-user kernels, im2col): 1e-4 max abs [3e-8];
- bf16 through the kernels, blocked and single-user: 2% relative
  Frobenius per leaf, against the reference's Pallas path (its kernels
  round to bf16 where the port's do) [3.3e-3 blocked, 1.4e-6
  single-user].  Against its xla path the gap is 2.6%: XLA, fusing the
  whole jitted round, drops some of those roundings;
- im2col at bf16 (autodiff in each framework): 5% [3.1%]; XLA sums the
  bias cotangent over the conv positions in bf16, torch in f32, see
  ``FROB_IM2COL_BF16`` in ``tests/test_torch_policy.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.fused_round import build_fused_round as j_round  # noqa: E402
from repro.core.hsfl import HSFLConfig as JConfig  # noqa: E402
from repro.core.hsfl import HSFLSimulation as JSim  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.fused_round import build_fused_round  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation  # noqa: E402
from repro_torch.kernels.fused_cnn import kernel as knl  # noqa: E402

torch.set_num_threads(1)

POLICIES = {
    "bf16-blocked": (dict(kernel="pallas", precision="bf16"), 0.02),
    "bf16-single": (dict(kernel="pallas", precision="bf16",
                         batch_users=False), 0.02),
    "im2col-f32": (dict(kernel="im2col"), None),
    "im2col-bf16": (dict(kernel="im2col", precision="bf16"), 0.05),
    "f32-single": (dict(batch_users=False), None),
}
CASES = [(s, p) for s in ("opt", "deadline", "opt_trimmed")
         for p in POLICIES if p != "f32-single"] + [("opt", "f32-single")]


def _cfg(cls, scheme, **kw):
    base = dict(rounds=2, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=3, scheme=scheme, seed=4,
                b=2)
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


@pytest.mark.parametrize("scheme,policy", CASES,
                         ids=[f"{s}-{p}" for s, p in CASES])
def test_policy_round_matches_jax_fused_engine(scheme, policy):
    kw, frob = POLICIES[policy]
    jsim = JSim(_cfg(JConfig, scheme, **kw))
    tsim = HSFLSimulation(_cfg(HSFLConfig, scheme, **kw), device="cpu")
    tsim.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsim.params), "cpu")
    knl.reset_launches()
    want, got = _run(jsim), _run(tsim)
    assert [r[0] for r in got] == [r[0] for r in want]
    if scheme == "opt":
        assert sum(r[0][2] for r in got) > 0, "fixture no longer rescues"
    jp = jax.tree_util.tree_map(np.asarray, jsim.params)
    tp = params_to_numpy(tsim.params)
    for layer in jp:
        for leaf in jp[layer]:
            a, b = tp[layer][leaf], jp[layer][leaf]
            assert a.dtype == np.float32
            if frob is None:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                           err_msg=f"{layer}.{leaf}")
            else:
                err = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert err <= frob, (layer, leaf, err)
    for (_, _, ta), (_, _, ja) in zip(got, want):
        assert abs(ta - ja) <= 3.0 / 100 + 1e-9


@pytest.mark.parametrize("kw", [
    dict(precision="bf16"), dict(precision="bf16", batch_users=False),
    dict(kernel="im2col", precision="bf16")],
    ids=["bf16-blocked", "bf16-single", "im2col-bf16"])
def test_evaluate_is_f32_under_any_policy(kw):
    """``HSFLSimulation.evaluate`` computes in f32 whatever the policy, as
    the reference's does (``cnn.forward``): on the same params its loss
    and accuracy equal the f32 policy's to the bit and the reference's
    within 1e-5 and one test image."""
    jsim = JSim(_cfg(JConfig, "opt", **kw))
    tsim = HSFLSimulation(_cfg(HSFLConfig, "opt", **kw), device="cpu")
    base = HSFLSimulation(_cfg(HSFLConfig, "opt"), device="cpu")
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jsim.params)
    jsim.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsim.params = params_from_numpy(params, "cpu")
    base.params = params_from_numpy(params, "cpu")
    jl, ja = jsim.evaluate()
    tl, ta = tsim.evaluate()
    assert (tl, ta) == base.evaluate()
    assert abs(tl - jl) <= 1e-5
    assert abs(ta - ja) <= 1.0 / 100 + 1e-9


def _linear_forward(params, x):
    return x @ params["w"]


def _round_inputs(k, e=2, steps=2, bs=3, dim=4, ncls=3):
    """A linear model's round: users 1 and 3 lose the final upload (user 1
    after a successful probe, so opt rescues it)."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(e, k, steps, bs, dim)).astype(np.float32)
    ys = rng.integers(0, ncls, (e, k, steps, bs)).astype(np.int32)
    outage = np.zeros((e, k), bool)
    outage[:, 3] = True
    chan = {
        "rates": np.full((e, k), 1e6, np.float32),
        "outages": outage,
        "payload_bits": np.full((k,), 1e5, np.float32),
        "tau_extra0": np.full((k,), 5.0, np.float32),
        "final_rate": np.full((k,), 1e6, np.float32),
        "final_outage": np.isin(np.arange(k), [1, 3]),
        "train_time": np.full((k,), 1.0, np.float32),
        "valid": np.ones((k,), bool),
    }
    params = {"w": rng.normal(size=(dim, ncls)).astype(np.float32)}
    return params, xs, ys, chan


@pytest.mark.parametrize("scheme", ["opt", "async"])
def test_bare_callable_round_matches_jax(scheme):
    """``build_fused_round(forward=<callable>)``: a tiny non-CNN model
    (x @ w) through the round by autograd, one user at a time, against the
    reference's vmapped autodiff epoch: equal stats, params within 1e-6."""
    k = 4
    params, xs, ys, chan = _round_inputs(k)
    kw = dict(scheme=scheme, local_epochs=2, steps_per_epoch=2, lr=0.1,
              tau_max=30.0, probe_epochs=(1,), async_weight=0.3, k_carry=k,
              forward=_linear_forward)
    jfn = j_round(**kw)
    tfn = build_fused_round(**kw)
    jchan = {n: jnp.asarray(v) for n, v in chan.items()}
    tchan = {n: torch.tensor(v) for n, v in chan.items()}
    tparams = params_from_numpy(params, "cpu")
    if scheme == "async":
        jout = jfn(jax.tree_util.tree_map(jnp.asarray, params),
                   {"w": jnp.zeros((k, 4, 3))}, jnp.zeros((k,), bool),
                   jnp.asarray(xs), jnp.asarray(ys), jchan)
        tout = tfn(tparams, {"w": torch.zeros((k, 4, 3))},
                   torch.zeros((k,), dtype=torch.bool), torch.tensor(xs),
                   torch.tensor(ys), tchan)
        np.testing.assert_allclose(tout[1]["w"].numpy(),
                                   np.asarray(jout[1]["w"]), atol=1e-6)
    else:
        jout = jfn(jax.tree_util.tree_map(jnp.asarray, params),
                   jnp.asarray(xs), jnp.asarray(ys), jchan)
        tout = tfn(tparams, torch.tensor(xs), torch.tensor(ys), tchan)
        assert bool(tout[-1].rescued[1])
    for name in ("arrived", "rescued", "delayed", "dropped", "opp_sends"):
        np.testing.assert_array_equal(
            getattr(tout[-1], name).numpy(),
            np.asarray(getattr(jout[-1], name)), err_msg=name)
    np.testing.assert_allclose(tout[0]["w"].numpy(), np.asarray(jout[0]["w"]),
                               atol=1e-6)
