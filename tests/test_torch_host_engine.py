"""The port's host reference engine (``use_fused_round=False``) on the CPU
against the JAX package.

- ``cnn.forward``: logits and autograd grads against ``jax.grad`` of
  ``repro.models.cnn.forward`` within 1e-6 (f32 summation order only), on
  random images and on tied ones.  JAX's gradient of ``reduce_window`` max
  goes to the first maximum of each window; the tied cases (all-ones
  images, and isolated pixels under a conv1 whose taps are all equal, where
  tied maxima have different patches) tell that rule from a split among
  ties, which is off by ~1e-2 there.
- the host engine against the JAX host engine for every registered scheme
  and for opt with the int8 and int4 codecs: per-round counts and bytes
  equal, params within 1e-4 (5e-4 for opt_clip, whose clip scale amplifies
  the order of the global-norm sums), test loss within 1e-4 and accuracy
  within one test image.
- the host engine against the port's own fused engine from the same seed:
  identical per-round counts (the reference's own host-vs-fused pin).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.hsfl import HSFLConfig as JConfig  # noqa: E402
from repro.core.hsfl import HSFLSimulation as JSim  # noqa: E402
from repro.core.schemes import registered_schemes  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.training.loss import cross_entropy as jce  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.training.loss import cross_entropy  # noqa: E402

torch.set_num_threads(1)


def _params(tied_taps: bool = False):
    p = jax.tree_util.tree_map(np.asarray,
                               jcnn.init_cnn(jax.random.PRNGKey(0)))
    # positive biases: ReLU(b) plateaus over constant regions
    p = {k: {"w": v["w"], "b": (v["b"] + 0.05).astype(np.float32)}
         for k, v in p.items()}
    if tied_taps:
        p["conv1"]["w"] = (np.full((3, 3, 1, 8), 0.3, np.float32)
                           * np.linspace(0.5, 1.5, 8, dtype=np.float32))
    return p


def _isolated_pixels(n: int, seed: int) -> np.ndarray:
    x = np.zeros((n, 28, 28, 1), np.float32)
    rng = np.random.default_rng(seed)
    for i in range(n):
        r, c = rng.integers(1, 27, (2, 12))
        x[i, r, c, 0] = 1.0
    return x


FORWARD_CASES = {
    "random": (lambda: np.random.default_rng(0).random(
        (6, 28, 28, 1)).astype(np.float32), False),
    "all-ones": (lambda: np.ones((6, 28, 28, 1), np.float32), False),
    "tied-taps-isolated-pixels": (lambda: _isolated_pixels(4, 3), True),
}


def _grads_torch(fwd, p, x, y):
    tp = params_from_numpy(p, "cpu")
    for layer in tp.values():
        for t in layer.values():
            t.requires_grad_(True)
    logits = fwd(tp, torch.from_numpy(x))
    cross_entropy(logits, torch.from_numpy(y)).backward()
    return logits.detach().numpy(), {
        a: {b: t.grad.numpy() for b, t in d.items()} for a, d in tp.items()}


def _max_err(got, want):
    return max(float(np.abs(got[a][b] - np.asarray(want[a][b])).max())
               for a in want for b in want[a])


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_and_grads_match_jax(case):
    make, tied_taps = FORWARD_CASES[case]
    x = make()
    y = np.arange(x.shape[0]) % 10
    p = _params(tied_taps)
    logits_j = jax.jit(jcnn.forward)(p, jnp.asarray(x))
    grads_j = jax.jit(jax.grad(
        lambda q, a, b: jce(jcnn.forward(q, a), b)))(p, jnp.asarray(x),
                                                     jnp.asarray(y))
    logits_t, grads_t = _grads_torch(cnn.forward, p, x, y)
    np.testing.assert_allclose(logits_t, np.asarray(logits_j), rtol=0,
                               atol=1e-5)
    assert _max_err(grads_t, grads_j) < 1e-6
    if case == "tied-taps-isolated-pixels":
        # the split-among-ties pool (forward_im2col's amax) disagrees here
        _, grads_split = _grads_torch(cnn.forward_im2col, p, x, y)
        assert _max_err(grads_split, grads_j) > 1e-3


def test_pool_routes_the_gradient_to_the_first_maximum():
    """Integer-valued windows tie often; JAX's reduce_window max sends each
    window's cotangent to its first maximum in row-major order."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 3, (2, 6, 8, 3)).astype(np.float32)
    c = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)

    def pool_j(a):
        return jax.lax.reduce_window(a, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                     (1, 2, 2, 1), "VALID")

    want = jax.grad(lambda a: jnp.sum(pool_j(a) * c))(jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_(True)
    out = cnn._pool2_first(yt)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(pool_j(jnp.asarray(y))))
    (out * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(yt.grad.numpy(), np.asarray(want))
    stacked = cnn._pool2_first(torch.from_numpy(y).reshape(1, 2, 6, 8, 3))
    np.testing.assert_array_equal(stacked[0].numpy(), out.detach().numpy())


# ---------------------------------------------------------------------------
# the host engine
# ---------------------------------------------------------------------------

def _cfg(cls, scheme, **kw):
    base = dict(rounds=2, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=3, scheme=scheme, seed=4,
                use_fused_round=False,
                b=2 if scheme.startswith("opt") or scheme == "deadline"
                else 1)
    base.update(kw)
    return cls(**base)


def _rows(sim):
    rows, delayed = [], []
    for t in range(1, sim.cfg.rounds + 1):
        log, delayed = sim.run_round(t, delayed)
        loss, acc = sim.evaluate()
        rows.append(((log.selected, log.arrived_final, log.used_snapshot,
                      log.delayed, log.dropped, log.bytes_sent), loss, acc))
    return rows


HOST_CASES = [(s, {}) for s in sorted(registered_schemes())] + [
    ("opt", {"use_delta_codec": True}),
    ("opt", {"use_delta_codec": True, "codec_bits": 4}),
    ("async", {"n_uavs": 3})]
HOST_IDS = [s for s in sorted(registered_schemes())] + [
    "opt-int8-codec", "opt-int4-codec", "async-padded"]


@pytest.mark.parametrize("scheme,extra", HOST_CASES, ids=HOST_IDS)
def test_host_engine_matches_jax_host_engine(scheme, extra):
    jsim = JSim(_cfg(JConfig, scheme, **extra))
    tsim = HSFLSimulation(_cfg(HSFLConfig, scheme, **extra), device="cpu")
    tsim.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsim.params), "cpu")
    want, got = _rows(jsim), _rows(tsim)
    assert [r[0] for r in got] == [r[0] for r in want]
    if scheme == "opt" and not extra:
        assert sum(r[0][2] for r in got) > 0, "fixture no longer rescues"
    if extra.get("n_uavs") == 3:
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


@pytest.mark.parametrize("scheme,extra", [
    ("opt", {}), ("async", {}), ("opt", {"use_delta_codec": True})],
    ids=["opt", "async", "opt-codec"])
def test_host_engine_counts_equal_fused_engine(scheme, extra):
    """Same seed, both engines of the port: identical per-round counts
    (the fused engine pads with zero users, the host engine with copies of
    user 0; neither slot is valid)."""
    host = HSFLSimulation(_cfg(HSFLConfig, scheme, rounds=3, **extra),
                          device="cpu")
    fused = HSFLSimulation(_cfg(HSFLConfig, scheme, rounds=3,
                                use_fused_round=True, **extra), device="cpu")
    fused.params = params_from_numpy(params_to_numpy(host.params), "cpu")
    got_h = [r[0] for r in _rows(host)]
    got_f = [r[0] for r in _rows(fused)]
    assert [r[:5] for r in got_h] == [r[:5] for r in got_f]
    for a, b in zip(got_h, got_f):
        assert a[5] == pytest.approx(b[5], rel=1e-12)
    hp, fp = params_to_numpy(host.params), params_to_numpy(fused.params)
    for layer in hp:
        for leaf in hp[layer]:
            np.testing.assert_allclose(hp[layer][leaf], fp[layer][leaf],
                                       rtol=0, atol=1e-4)
