"""The port's forward policies (bf16, single-user kernels, im2col) on the
CPU against the JAX package.

The same numpy inputs go through the reference (its ``ref.py`` twins under
``jax.jit``, its single-user Pallas kernels with ``interpret=True``, its
``ops.py`` policy layer) and the port's kernel wrappers on CPU tensors,
which run the port's plain twins.  Sizes are small: one user or K ≤ 3,
B ≤ 4 (10 in the epoch fixture the reference's own pins use).

Tolerances and the gaps measured at these sizes:
- f32: the reference's own (``tests/test_fused_cnn.py``): grads within
  ``atol=2e-7, rtol=1e-5``; residuals and the conv forward exactly.
- bf16 compute-dtype outputs: bitwise equal on at least 99% of elements
  and within two bf16 ulps (``rtol=2**-6``) elsewhere, outside pool
  windows whose tie masks differ (counted and reported).  Measured: every
  bf16 output (a, pat, eq, relu_m, h1, h2, logits, dflat, dx) bitwise
  equal to the jitted reference and to the interpret-mode kernels; no
  tie window differs.
- bf16 f32 grads: within 2% relative Frobenius error per leaf.  Measured
  below 3e-7: the weight grads are f32 sums of bf16 products in another
  order, and the reference under ``jax.jit`` does not round them to bf16
  (see ``repro_torch/kernels/fused_cnn/ref.py``).
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_digits  # noqa: E402
from repro.kernels.fused_cnn import kernel as jknl  # noqa: E402
from repro.kernels.fused_cnn import ref as jref  # noqa: E402
from repro.kernels.fused_cnn.ops import (  # noqa: E402
    ForwardPolicy as JPolicy, make_eval_forward as j_eval_forward,
    make_forward as j_forward, make_stacked_epoch_fn as j_epoch,
    make_stacked_loss_grad as j_loss_grad)
from repro.models import cnn as jcnn  # noqa: E402
from repro.training.loss import cross_entropy as jce  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.fused_cnn import kernel as tknl  # noqa: E402
from repro_torch.kernels.fused_cnn import ops  # noqa: E402
from repro_torch.kernels.fused_cnn.ops import ForwardPolicy  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.training.loss import cross_entropy  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

GRAD_TOL = dict(atol=2e-7, rtol=1e-5)       # the reference's own
# one layer under a synthetic cotangent (0.05·N(0,1), larger than a real
# one): sums that differ only in order, as tests/test_torch_fused_cnn.py
TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 2 ** -6                         # two bf16 ulps
FROB = 0.02                                 # relative Frobenius, f32 grads
# im2col at bf16 is autodiff in each framework: XLA sums the bias
# cotangent over the 3136 conv1 positions in bf16, torch in f32 and rounds
# once, so conv1.b's gradient differs by 2.8% (both are 5.5% from the f32
# gradient; every weight gradient is bitwise equal without jit)
FROB_IM2COL_BF16 = 0.05
BF = jnp.bfloat16


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _params(rng, lead=()):
    """Numpy CNN params at the reference's fan-in scales (small random
    biases so the bias paths carry signal); ``lead`` stacks users."""
    def layer(*shape, fan_in):
        return {"w": (rng.standard_normal(lead + shape) * fan_in ** -0.5
                      ).astype(np.float32),
                "b": (rng.standard_normal(lead + shape[-1:]) * 0.01
                      ).astype(np.float32)}
    return {"conv1": layer(3, 3, 1, 8, fan_in=9),
            "conv2": layer(3, 3, 8, 16, fan_in=72),
            "fc1": layer(784, 128, fan_in=784),
            "fc2": layer(128, 64, fan_in=128),
            "fc3": layer(64, 10, fan_in=64)}


def _data(n, seed, ones=False):
    if ones:
        return (np.ones((n, 28, 28, 1), np.float32),
                np.tile(np.asarray([1, 7], np.int32), n // 2))
    ds = make_digits(n, seed=seed)
    return ds.x, ds.y


def _grads_close(got, want):
    got = params_to_numpy(got)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(_np(got[layer][leaf]),
                                       _np(want[layer][leaf]), **GRAD_TOL,
                                       err_msg=f"{layer}.{leaf}")


def _frob(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _grads_frob(got, want, tol=FROB):
    got = params_to_numpy(got)
    for layer in want:
        for leaf in want[layer]:
            err = _frob(got[layer][leaf], want[layer][leaf])
            assert err <= tol, (layer, leaf, err)
            assert got[layer][leaf].dtype == np.float32


def _tie_windows(eq_t, eq_j) -> np.ndarray:
    """(..., H, W, O) eq masks -> (..., H/2, W/2, O) bool: windows whose
    masks differ anywhere."""
    d = _np(eq_t) != _np(eq_j)
    *lead, h, w, o = d.shape
    return d.reshape(*lead, h // 2, 2, w // 2, 2, o).any(axis=(-4, -2))


def _bf16_close(got, want, skip=None):
    """Bitwise on ≥ 99% of elements, two bf16 ulps elsewhere; ``skip``
    masks elements of windows whose tie masks differ."""
    g, w = _np(got), _np(want)
    keep = np.ones(g.shape, bool) if skip is None else ~skip
    assert np.mean(g[keep] == w[keep]) >= 0.99
    np.testing.assert_allclose(g[keep], w[keep], rtol=BF16_RTOL,
                               atol=BF16_RTOL * float(np.abs(w).max()))


def _up(win):
    """Window mask (..., H/2, W/2, O) -> element mask (..., H, W, O)."""
    return np.repeat(np.repeat(win, 2, axis=-3), 2, axis=-2)


# ---------------------------------------------------------------------------
# single-user kernels at f32
# ---------------------------------------------------------------------------

def _layer_input(params, x, layer):
    if layer == "conv1":
        return x
    a1, _ = jref.conv_pool_fwd(jnp.asarray(x), params["conv1"]["w"],
                               params["conv1"]["b"])
    return np.asarray(a1)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("layer", ["conv1", "conv2"])
@pytest.mark.parametrize("ones", [False, True], ids=["digits", "ones-tie"])
def test_single_user_conv_twins_match_jax(ones, layer, need_dx):
    """conv_pool_fwd/bwd for one user (B=4) against the reference's
    single-user Pallas kernels (interpret) and ref.py twins (measured: a
    and the grads within 7e-7 absolute, residuals equal)."""
    params = _params(np.random.default_rng(1))
    x, _ = _data(4, 2, ones)
    xin = _layer_input(params, x, layer)
    w, b = params[layer]["w"], params[layer]["b"]
    a_t, res_t = tknl.conv_pool_fwd(torch.tensor(xin), torch.tensor(w),
                                    torch.tensor(b))
    da = np.random.default_rng(3).standard_normal(a_t.shape).astype(
        np.float32) * 0.05
    got = tknl.conv_pool_bwd(res_t, torch.tensor(w), torch.tensor(da),
                             need_dx)
    for fwd, bwd in (
            (lambda: jknl.conv_pool_fwd(jnp.asarray(xin), w, b,
                                        interpret=True),
             lambda r: jknl.conv_pool_bwd(r, w, jnp.asarray(da), need_dx,
                                          interpret=True)),
            (lambda: jref.conv_pool_fwd(jnp.asarray(xin), w, b),
             lambda r: jref.conv_pool_bwd(r, w, jnp.asarray(da), need_dx))):
        a_j, res_j = fwd()
        # z sums in another order than XLA's dot: a to summation order;
        # ties are between exact zeros, so the masks agree exactly
        np.testing.assert_allclose(_np(a_t), _np(a_j), **TOL)
        for gt, gj in zip(res_t, res_j):
            np.testing.assert_array_equal(_np(gt), _np(gj))
        for gt, gj in zip(got, bwd(res_j)):
            if gj is None:
                assert gt is None
            else:
                np.testing.assert_allclose(_np(gt), _np(gj), **TOL)


@pytest.mark.parametrize("ones", [False, True], ids=["digits", "ones-tie"])
def test_single_user_fc_twins_and_step_match_jax(ones):
    """fc_chain_fwd/bwd for one user and the whole hand-written step
    (forward_fwd + backward with the image gradient) against the
    reference's single-user kernels (interpret) and ref.py."""
    params = _params(np.random.default_rng(4))
    x, y = _data(4, 5, ones)
    tp = params_from_numpy(params, "cpu")
    a2 = np.asarray(jref.conv_pool_fwd(
        _layer_input(params, x, "conv2"), params["conv2"]["w"],
        params["conv2"]["b"])[0])
    flat = a2.reshape(4, -1)
    lt, rt = tknl.fc_chain_fwd(torch.tensor(flat), tp)
    g = np.random.default_rng(5).standard_normal((4, 10)).astype(
        np.float32) * 0.1
    gt, dft = tknl.fc_chain_bwd(torch.tensor(flat), rt, tp, torch.tensor(g))
    for mod, kw in ((jknl, {"interpret": True}), (jref, {})):
        lj, rj = mod.fc_chain_fwd(jnp.asarray(flat), params, **kw)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-6)
        for a, b_ in zip(rt, rj):
            np.testing.assert_allclose(_np(a), _np(b_), rtol=1e-5, atol=1e-6)
        gj, dfj = mod.fc_chain_bwd(jnp.asarray(flat), rj, params,
                                   jnp.asarray(g), **kw)
        np.testing.assert_allclose(_np(dft), _np(dfj), **GRAD_TOL)
        _grads_close(gt, gj)
    lj, resj = jref.forward_fwd_ref(params, jnp.asarray(x))
    gj, dxj = jref.backward_ref(params, resj, jnp.asarray(g), need_dx=True)
    lt, rest = ops.forward_fwd(tp, torch.tensor(x))
    gt, dxt = ops.backward(tp, rest, torch.tensor(g), need_dx=True)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(dxt), _np(dxj), **GRAD_TOL)
    _grads_close(gt, gj)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_batch_users_false_epoch_equals_blocked_epoch_bitwise(precision):
    """The single-user epoch (a loop over users, one launch per user slot
    per layer) and the blocked epoch give the same params bit for bit:
    the reference pins this at f32 (``test_fused_cnn.py``); in the port it
    holds at bf16 too, since both sum in one order and round alike."""
    k, steps, bs = 3, 4, 10
    params = _params(np.random.default_rng(0), (k,))
    xs, ys = _data(k * steps * bs, 2)
    xs = torch.tensor(xs.reshape(k, steps, bs, 28, 28, 1))
    ys = torch.tensor(ys.reshape(k, steps, bs))
    out = []
    for users in (True, False):
        pol = ForwardPolicy(precision=precision, batch_users=users)
        out.append(ops.make_stacked_epoch_fn(pol, 0.05)(
            params_from_numpy(params, "cpu"), xs, ys))
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# make_forward: autograd through the hand-written backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["xla", "im2col"])
@pytest.mark.parametrize("ones", [False, True], ids=["digits", "ones-tie"])
def test_make_forward_grads_match_jax_grad(kernel, ones):
    """``torch.autograd.grad`` through the port's ``make_forward`` against
    ``jax.grad`` of the reference's, params and image gradient (f32)."""
    params = _params(np.random.default_rng(7))
    x, y = _data(4, 8, ones)
    jfwd = j_forward(JPolicy(kernel=kernel))
    lj, (gj, dxj) = jax.value_and_grad(
        lambda p, xx: jce(jfwd(p, xx), jnp.asarray(y)), argnums=(0, 1))(
            params, jnp.asarray(x))
    tfwd = ops.make_forward(ForwardPolicy(kernel=kernel))
    tp = tree_map(lambda t: t.requires_grad_(True),
                  params_from_numpy(params, "cpu"))
    tx = torch.tensor(x, requires_grad=True)
    loss = cross_entropy(tfwd(tp, tx), torch.tensor(y))
    grads = torch.autograd.grad(loss, tree_leaves(tp) + [tx])
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(_np(grads[-1]), _np(dxj), **GRAD_TOL)
    want = [gj[n][leaf] for n in sorted(gj) for leaf in sorted(gj[n])]
    for g, w in zip(grads[:-1], want):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL)


@pytest.mark.parametrize("kernel", ["xla", "im2col"])
def test_make_forward_bf16_grads_are_f32_and_match_jax(kernel):
    """At bf16 the grads (params and image) come back f32 and agree with
    ``jax.grad`` of the reference's bf16 forward: within 2% Frobenius per
    leaf for xla (measured below 1e-6: the twins round where the
    reference does), 5% for im2col (``FROB_IM2COL_BF16``; measured 2.8%
    on conv1.b, below 0.6% elsewhere)."""
    tol = FROB if kernel == "xla" else FROB_IM2COL_BF16
    params = _params(np.random.default_rng(9))
    x, y = _data(4, 10)
    jfwd = j_forward(JPolicy(kernel=kernel, precision="bf16"))
    gj, dxj = jax.grad(lambda p, xx: jce(jfwd(p, xx), jnp.asarray(y)),
                       argnums=(0, 1))(params, jnp.asarray(x))
    tfwd = ops.make_forward(ForwardPolicy(kernel=kernel, precision="bf16"))
    tp = tree_map(lambda t: t.requires_grad_(True),
                  params_from_numpy(params, "cpu"))
    tx = torch.tensor(x, requires_grad=True)
    logits = tfwd(tp, tx)
    assert logits.dtype == torch.float32
    grads = torch.autograd.grad(cross_entropy(logits, torch.tensor(y)),
                                tree_leaves(tp) + [tx])
    assert all(g.dtype == torch.float32 for g in grads)
    assert _frob(grads[-1], dxj) <= tol
    got = {}
    names = [(n, leaf) for n in sorted(gj) for leaf in sorted(gj[n])]
    for (n, leaf), g in zip(names, grads[:-1]):
        got.setdefault(n, {})[leaf] = g
    _grads_frob(got, gj, tol)


@pytest.mark.parametrize("policy", [
    ForwardPolicy(precision="bf16"), ForwardPolicy(kernel="im2col"),
    ForwardPolicy(kernel="im2col", precision="bf16")],
    ids=["xla-bf16", "im2col-f32", "im2col-bf16"])
def test_eval_forward_matches_jax(policy):
    """``make_eval_forward`` at the policy's precision against the
    reference's (bf16 xla: bitwise; im2col: to its rounding)."""
    params = _params(np.random.default_rng(11))
    x, _ = _data(20, 12)
    want = j_eval_forward(JPolicy(kernel=policy.kernel,
                                  precision=policy.precision))(
        params, jnp.asarray(x))
    got = ops.make_eval_forward(policy)(params_from_numpy(params, "cpu"),
                                        torch.tensor(x))
    assert got.dtype == torch.float32
    if policy.kernel == "xla":
        np.testing.assert_array_equal(_np(got), _np(want))
    elif policy.precision == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert _frob(got, want) <= FROB


def test_forward_im2col_compute_dtype_matches_jax():
    """``cnn.forward_im2col(_k)`` with ``compute_dtype=bf16``: f32 logits
    within 2% Frobenius of the reference's."""
    sp = _params(np.random.default_rng(13), (2,))
    x, _ = _data(6, 14)
    xs = x.reshape(2, 3, 28, 28, 1)
    got = tcnn.forward_im2col_k(params_from_numpy(sp, "cpu"),
                                torch.tensor(xs), torch.bfloat16)
    want = jcnn.forward_im2col_k(sp, jnp.asarray(xs), compute_dtype=BF)
    assert got.dtype == torch.float32
    assert _frob(got, want) <= FROB


# ---------------------------------------------------------------------------
# bf16 twins against the reference's bf16 ref.py
# ---------------------------------------------------------------------------

def _tb(a):
    return torch.tensor(_np(a)).to(torch.bfloat16)


def _jb(a):
    return jnp.asarray(np.asarray(_np(a))).astype(BF)


@pytest.mark.parametrize("ones", [False, True], ids=["digits", "ones-tie"])
@pytest.mark.parametrize("blocked", [True, False], ids=["blocked-K3",
                                                        "single"])
def test_bf16_twins_match_jax(blocked, ones):
    """Every bf16 twin against the reference's jitted bf16 ``ref.py``
    (blocked ``*_k`` at K=3 and single-user), on inputs rounded to bf16
    once: compute-dtype outputs bitwise on ≥ 99% and within two ulps
    outside differing tie windows, f32 grads within 2% Frobenius."""
    k, bs = 3, 4
    params = _params(np.random.default_rng(15), (k,) if blocked else ())
    x, _ = _data(k * bs if blocked else bs, 16, ones)
    x = x.reshape((k, bs, 28, 28, 1) if blocked else (bs, 28, 28, 1))
    jp = tree_map(_jb, params)
    tp = tree_map(_tb, params)
    sfx = "_k" if blocked else ""
    jfwd = jax.jit(getattr(jref, "conv_pool_fwd" + sfx))
    jbwd = jax.jit(getattr(jref, "conv_pool_bwd" + sfx),
                   static_argnums=(3,))
    tfwd = getattr(tknl, "conv_pool_fwd" + sfx)
    tbwd = getattr(tknl, "conv_pool_bwd" + sfx)
    inp = _jb(x)
    worst_windows = 0
    for layer in ("conv1", "conv2"):
        a_j, r_j = jfwd(inp, jp[layer]["w"], jp[layer]["b"])
        a_t, r_t = tfwd(_tb(inp), tp[layer]["w"], tp[layer]["b"])
        win = _tie_windows(r_t[1], r_j[1])
        worst_windows = max(worst_windows, int(win.sum()))
        assert win.mean() <= 0.01
        _bf16_close(a_t, a_j, win)
        _bf16_close(r_t[0], r_j[0])
        _bf16_close(r_t[1], r_j[1], _up(win))
        _bf16_close(r_t[2], r_j[2], win)
        da = np.random.default_rng(17).standard_normal(a_j.shape).astype(
            np.float32) * 0.05
        out_j = jbwd(r_j, jp[layer]["w"], _jb(da), True)
        out_t = tbwd(tuple(_tb(r) for r in r_j), tp[layer]["w"], _tb(da),
                     True)
        assert _frob(out_t[0], out_j[0]) <= FROB
        assert _frob(out_t[1], out_j[1]) <= FROB
        assert out_t[0].dtype == out_t[1].dtype == torch.float32
        _bf16_close(out_t[2], out_j[2])
        inp = a_j
    assert worst_windows == 0, "tie windows differ (count above)"
    flat = inp.reshape(inp.shape[:-3] + (-1,))
    lj, rj = jax.jit(getattr(jref, "fc_chain_fwd" + sfx))(flat, jp)
    lt, rt = getattr(tknl, "fc_chain_fwd" + sfx)(_tb(flat), tp)
    for a, b in zip((lt, *rt), (lj, *rj)):
        _bf16_close(a, b)
    g = np.random.default_rng(18).standard_normal(lj.shape).astype(
        np.float32) * 0.1
    gj, dfj = jax.jit(getattr(jref, "fc_chain_bwd" + sfx))(flat, rj, jp,
                                                           _jb(g))
    gt, dft = getattr(tknl, "fc_chain_bwd" + sfx)(
        _tb(flat), tuple(_tb(r) for r in rj), tp, _tb(g))
    _bf16_close(dft, dfj)
    _grads_frob(gt, gj)


# ---------------------------------------------------------------------------
# bf16 loss bands (the reference's pins, repeated on the port)
# ---------------------------------------------------------------------------

def _train(fwd, params, x, y, steps=150, lr=0.1, bs=32):
    """The reference's ``_train``: SGD through ``fwd`` by autograd; the
    loss of each step's batch after its update."""
    losses = []
    for i in range(steps):
        lo = (i * bs) % (x.shape[0] - bs)
        bx, by = x[lo:lo + bs], y[lo:lo + bs]
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        g = torch.autograd.grad(cross_entropy(fwd(p, bx), by),
                                tree_leaves(p))
        it = iter(g)
        params = tree_map(lambda w: (w - lr * next(it)).detach(), p)
        with torch.no_grad():
            losses.append(float(cross_entropy(fwd(params, bx), by)))
    return params, np.asarray(losses)


def test_bf16_policy_loss_curve_tracks_f32():
    """The bf16 step trains: master params and grads stay f32, and the
    loss curve stays within 0.15 of the f32 run's (the reference's pin,
    ``tests/test_fused_cnn.py``).  Measured here: the last-5 mean losses
    differ by under 0.01."""
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(1))), "cpu")
    x, y = _data(400, 2)
    x, y = torch.tensor(x), torch.tensor(y)
    p32, l32 = _train(ops.make_forward(ForwardPolicy()), params, x, y)
    pbf, lbf = _train(ops.make_forward(ForwardPolicy(precision="bf16")),
                      params, x, y)
    assert all(t.dtype == torch.float32 for t in tree_leaves(pbf))
    assert l32[-5:].mean() < 0.2 * l32[0]
    assert lbf[-5:].mean() < 0.2 * lbf[0]
    assert abs(float(lbf[-5:].mean() - l32[-5:].mean())) < 0.15, (
        lbf[-5:], l32[-5:])


# the reference's Pallas path is the bf16 oracle of the port's kernel path:
# its kernels round to bf16 where the port's do.  Its xla path, jitted as
# one program, lets XLA drop some of those roundings (the logits' before
# the loss, measured), 0.7% apart per step
JPALLAS_BF16 = JPolicy(kernel="pallas", interpret=True, precision="bf16")


@pytest.mark.parametrize("kernel", ["xla", "im2col"])
def test_bf16_stacked_epoch_master_roundtrip_and_loss(kernel):
    """Ten bf16 epochs (blocked K=3, 4 steps of 10): the master stays f32
    and the loss falls like the f32 run's (the reference's band: 0.8× the
    start, within 0.15 of f32).  After the first two epochs the params
    are held to the reference's own bf16 epochs (xla: the epoch-boundary
    master, to the Pallas path within 2%; im2col: the per-step f32 master,
    within 5%).  Later the two bf16 trajectories drift apart as bf16
    trajectories do: a one-ulp difference in a bf16 weight changes later
    roundings (measured after ten epochs: 2.3% on conv1.b for xla, 7.4%
    for im2col; every other leaf below 0.5%)."""
    k, steps, bs = 3, 4, 10
    params = _params(np.random.default_rng(0), (k,))
    xs, ys = _data(k * steps * bs, 2)
    xs, ys = xs.reshape(k, steps, bs, 28, 28, 1), ys.reshape(k, steps, bs)
    tx, ty = torch.tensor(xs), torch.tensor(ys)

    def cohort_loss(p):
        logits = tcnn.forward_im2col_k(p, tx.reshape(k, -1, 28, 28, 1))
        return float(torch.mean(torch.stack([
            cross_entropy(logits[i], ty.reshape(k, -1)[i])
            for i in range(k)])))

    f32_fn = ops.make_stacked_epoch_fn(ForwardPolicy(kernel=kernel), 0.02)
    bf_fn = ops.make_stacked_epoch_fn(
        ForwardPolicy(kernel=kernel, precision="bf16"), 0.02)
    jpol = JPALLAS_BF16 if kernel == "xla" else JPolicy(kernel=kernel,
                                                         precision="bf16")
    jbf = jax.jit(j_epoch(jpol, 0.02))
    p32 = params_from_numpy(params, "cpu")
    pbf = params_from_numpy(params, "cpu")
    pj = params
    for epoch in range(10):
        p32, pbf = f32_fn(p32, tx, ty), bf_fn(pbf, tx, ty)
        if epoch < 2:
            pj = jbf(pj, jnp.asarray(xs), jnp.asarray(ys))
            pbf_2 = tree_map(torch.clone, pbf)
    _grads_frob(pbf_2, pj, FROB if kernel == "xla" else FROB_IM2COL_BF16)
    assert all(t.dtype == torch.float32 for t in tree_leaves(pbf))
    loss0 = cohort_loss(params_from_numpy(params, "cpu"))
    l32, lbf = cohort_loss(p32), cohort_loss(pbf)
    assert l32 < 0.8 * loss0 and lbf < 0.8 * loss0, (loss0, l32, lbf)
    assert abs(lbf - l32) < 0.15, (l32, lbf)


@pytest.mark.parametrize("users", [True, False], ids=["blocked", "single"])
def test_bf16_stacked_loss_grad_matches_jax(users):
    """The bf16 loss-grad over a K=3 cohort against the reference's
    (jitted): against its Pallas path losses to 1e-6 relative and grads
    within 2% Frobenius (measured 1e-7: summation order); against its xla
    path losses to 1e-3 (measured 2.7e-4: XLA keeps the logits unrounded)
    and grads within 2% (measured 0.7%)."""
    k = 3
    params = _params(np.random.default_rng(21), (k,))
    x, y = _data(k * 4, 22)
    x, y = x.reshape(k, 4, 28, 28, 1), y.reshape(k, 4)
    tl, tg = ops.make_stacked_loss_grad(
        ForwardPolicy(precision="bf16", batch_users=users))(
        params_from_numpy(params, "cpu"), torch.tensor(x), torch.tensor(y))
    assert tl.dtype == torch.float32
    for jpol, rtol in ((JPALLAS_BF16, 1e-6), (JPolicy(precision="bf16"),
                                                1e-3)):
        jl, jg = jax.jit(j_loss_grad(replace(jpol, batch_users=users)))(
            params, jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=rtol)
        _grads_frob(tg, jg)
