"""The port's fused-CNN kernels (CPU twins) against the JAX package.

The same numpy inputs go through the reference's blocked Pallas kernels
(``interpret=True``, as ``tests/test_fused_cnn.py`` runs them), its
``ref.py`` twins, and the port's kernel wrappers on CPU tensors (which run
the port's plain twins), at K ∈ {1, 3}, B = 4, both conv layers, with and
without the image gradient, plus the all-ones pool-tie / dead-ReLU cohort.
Then the stacked loss-grad and one SGD epoch against the reference's
``make_stacked_loss_grad`` / ``make_stacked_epoch_fn`` on the Pallas path.

Tolerances: f32 values that only differ by summation order (the port sums
products in another order than XLA's dot) agree to a few ulps of the
largest term, so ``rtol=1e-5, atol=1e-6``.  Patches are copies and must be
equal; the pool tie mask and ReLU mask come from comparisons of values
that are exactly equal in both packages (zero patches, constant images),
so they are compared exactly too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_digits  # noqa: E402
from repro.kernels.fused_cnn import kernel as jknl  # noqa: E402
from repro.kernels.fused_cnn import ref as jref  # noqa: E402
from repro.kernels.fused_cnn.ops import (  # noqa: E402
    ForwardPolicy as JPolicy, make_stacked_epoch_fn as j_epoch,
    make_stacked_loss_grad as j_loss_grad)
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.fused_cnn import kernel as tknl  # noqa: E402
from repro_torch.kernels.fused_cnn import ops  # noqa: E402
from repro_torch.kernels.fused_cnn import ref as tref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from repro_torch.kernels.fused_cnn.ops import (  # noqa: E402
    ForwardPolicy, make_eval_forward, make_stacked_epoch_fn,
    make_stacked_loss_grad)

torch.set_num_threads(1)

PALLAS = JPolicy(kernel="pallas", interpret=True)
TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


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


def _cohort(k, bs=4, seed=0, ones=False):
    """Stacked numpy params and numpy images for a K-user cohort."""
    params = _params(np.random.default_rng(seed), (k,))
    if ones:
        x = np.ones((k, bs, 28, 28, 1), np.float32)
        y = np.tile(np.asarray([1, 7], np.int32), (k, bs // 2))
    else:
        ds = make_digits(k * bs, seed=seed + 1)
        x = ds.x.reshape(k, bs, 28, 28, 1)
        y = ds.y.reshape(k, bs)
    return params, x, y


def _layer_input(params, x, layer):
    """conv1 takes the images; conv2 takes the reference's conv1 output
    (ReLU zeros: zero patches, exact z = 0 ties)."""
    if layer == "conv1":
        return x
    a1, _ = jref.conv_pool_fwd_k(jnp.asarray(x), params["conv1"]["w"],
                                 params["conv1"]["b"])
    return np.asarray(a1)


@pytest.mark.parametrize("layer", ["conv1", "conv2"])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_pool_fwd_matches_pallas_and_ref(k, layer):
    params, x, _ = _cohort(k)
    xin = _layer_input(params, x, layer)
    w, b = params[layer]["w"], params[layer]["b"]
    a_p, res_p = jknl.conv_pool_fwd_k(jnp.asarray(xin), w, b, interpret=True)
    a_r, res_r = jref.conv_pool_fwd_k(jnp.asarray(xin), w, b)
    a_t, res_t = tknl.conv_pool_fwd_k(torch.tensor(xin), torch.tensor(w),
                                      torch.tensor(b))
    for want_a, want_res in ((a_p, res_p), (a_r, res_r)):
        _close(a_t, want_a)
        for got, want in zip(res_t, want_res):
            np.testing.assert_array_equal(_np(got), _np(want))
    a_only, none = tknl.conv_pool_fwd_k(torch.tensor(xin), torch.tensor(w),
                                        torch.tensor(b), residuals=False)
    assert none is None
    np.testing.assert_array_equal(_np(a_only), _np(a_t))


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("layer", ["conv1", "conv2"])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_pool_bwd_matches_pallas_and_ref(k, layer, need_dx):
    params, x, _ = _cohort(k)
    xin = _layer_input(params, x, layer)
    w, b = params[layer]["w"], params[layer]["b"]
    a, res = jref.conv_pool_fwd_k(jnp.asarray(xin), w, b)
    da = np.random.default_rng(k).standard_normal(a.shape).astype(
        np.float32) * 0.05
    want_p = jknl.conv_pool_bwd_k(res, w, jnp.asarray(da), need_dx,
                                  interpret=True)
    want_r = jref.conv_pool_bwd_k(res, w, jnp.asarray(da), need_dx)
    got = tknl.conv_pool_bwd_k(tuple(torch.tensor(np.asarray(r))
                                     for r in res),
                               torch.tensor(w), torch.tensor(da), need_dx)
    for want in (want_p, want_r):
        for g, wv in zip(got, want):
            if wv is None:
                assert g is None
            else:
                _close(g, wv)


@pytest.mark.parametrize("k", [1, 3])
def test_fc_chain_fwd_and_bwd_match_pallas_and_ref(k):
    params, x, y = _cohort(k)
    a1, _ = jref.conv_pool_fwd_k(jnp.asarray(x), params["conv1"]["w"],
                                 params["conv1"]["b"])
    a2, _ = jref.conv_pool_fwd_k(a1, params["conv2"]["w"],
                                 params["conv2"]["b"])
    flat = np.asarray(a2).reshape(k, x.shape[1], -1)
    tp = params_from_numpy(params, "cpu")
    lt, (h1t, h2t) = tknl.fc_chain_fwd_k(torch.tensor(flat), tp)
    for fwd in (lambda: jknl.fc_chain_fwd_k(jnp.asarray(flat), params,
                                            interpret=True),
                lambda: jref.fc_chain_fwd_k(jnp.asarray(flat), params)):
        lj, (h1j, h2j) = fwd()
        _close(lt, lj)
        _close(h1t, h1j)
        _close(h2t, h2j)

    _, rfc = jref.fc_chain_fwd_k(jnp.asarray(flat), params)
    g = np.random.default_rng(k).standard_normal(
        (k, x.shape[1], 10)).astype(np.float32) * 0.1
    gt, dft = tknl.fc_chain_bwd_k(
        torch.tensor(flat), tuple(torch.tensor(np.asarray(r)) for r in rfc),
        tp, torch.tensor(g))
    for bwd in (lambda: jknl.fc_chain_bwd_k(jnp.asarray(flat), rfc, params,
                                            jnp.asarray(g), interpret=True),
                lambda: jref.fc_chain_bwd_k(jnp.asarray(flat), rfc, params,
                                            jnp.asarray(g))):
        gj, dfj = bwd()
        _close(dft, dfj)
        for layer in ("fc1", "fc2", "fc3"):
            for leaf in ("w", "b"):
                _close(gt[layer][leaf], gj[layer][leaf])


def _grads_close(got, want):
    want = jax.tree_util.tree_map(np.asarray, want)
    got = params_to_numpy(got)
    for layer in want:
        for leaf in want[layer]:
            _close(got[layer][leaf], want[layer][leaf],
                   err_msg=f"{layer}.{leaf}")


@pytest.mark.parametrize("case", ["digits-k1", "digits-k3", "ones-tie"])
def test_stacked_loss_grad_matches_jax(case):
    """The port's step (closed-form CE cotangent + hand-written backward)
    vs the reference's on the Pallas path; the all-ones cohort puts every
    pool window in a 4-way tie and leaves dead-ReLU lanes."""
    if case == "ones-tie":
        params, x, y = _cohort(3, bs=2, ones=True)
    else:
        params, x, y = _cohort(int(case[-1]))
    lj, gj = j_loss_grad(PALLAS)(params, jnp.asarray(x), jnp.asarray(y))
    lt, gt = make_stacked_loss_grad(ForwardPolicy())(
        params_from_numpy(params, "cpu"), torch.tensor(x), torch.tensor(y))
    assert tuple(lt.shape) == (x.shape[0],)
    _close(lt, lj)
    _grads_close(gt, gj)


def test_one_epoch_matches_jax():
    """One local epoch (2 SGD steps, lr 0.05) for a K=3 cohort: the port's
    in-place loop against the reference's scanned Pallas epoch."""
    k, steps, bs = 3, 2, 4
    params, _, _ = _cohort(k)
    ds = make_digits(k * steps * bs, seed=7)
    xs = ds.x.reshape(k, steps, bs, 28, 28, 1)
    ys = ds.y.reshape(k, steps, bs)
    want = j_epoch(PALLAS, 0.05)(params, jnp.asarray(xs), jnp.asarray(ys))
    stacked = params_from_numpy(params, "cpu")
    got = make_stacked_epoch_fn(ForwardPolicy(), 0.05)(
        stacked, torch.tensor(xs), torch.tensor(ys))
    assert got is stacked                     # updated in place
    _grads_close(got, want)


def test_eval_forward_matches_reference_forward():
    """Eval goes through the forward kernels at K=1 (no residuals); the
    reference evaluates with ``cnn.forward``."""
    params = _params(np.random.default_rng(5))
    x = make_digits(50, seed=3).x
    want = jcnn.forward(params, jnp.asarray(x))
    got = make_eval_forward(ForwardPolicy())(params_from_numpy(params, "cpu"),
                                             torch.tensor(x))
    _close(got, want)


def test_twin_composition_matches_reference_with_image_grad():
    """The port's whole-model twins (forward + residuals, hand-written
    backward with the image gradient) against the reference's ``ref.py``
    composition, and the port's kernel-path step equal to its twins on
    CPU tensors."""
    params, x, y = _cohort(3)
    g = np.random.default_rng(3).standard_normal((3, 4, 10)).astype(
        np.float32) * 0.1
    lj, rj = jref.forward_fwd_ref_k(params, jnp.asarray(x))
    gj, dxj = jref.backward_ref_k(params, rj, jnp.asarray(g), need_dx=True)
    tp = params_from_numpy(params, "cpu")
    lt, rt = tref.forward_fwd_ref_k(tp, torch.tensor(x))
    gt, dxt = tref.backward_ref_k(tp, rt, torch.tensor(g), need_dx=True)
    _close(lt, lj)
    _close(dxt, dxj)
    _grads_close(gt, gj)
    lo, ro = ops.forward_fwd_k(tp, torch.tensor(x))
    go, dxo = ops.backward_k(tp, ro, torch.tensor(g), need_dx=True)
    np.testing.assert_array_equal(_np(lo), _np(lt))
    np.testing.assert_array_equal(_np(dxo), _np(dxt))


def test_model_module_matches_reference():
    """forward_im2col(_k), init shapes and the SL split against
    ``repro.models.cnn``."""
    params = _params(np.random.default_rng(9))
    x = make_digits(6, seed=4).x
    tp = params_from_numpy(params, "cpu")
    _close(tcnn.forward_im2col(tp, torch.tensor(x)),
           jcnn.forward_im2col(params, jnp.asarray(x)))
    sp, xs, _ = _cohort(2, bs=3)
    _close(tcnn.forward_im2col_k(params_from_numpy(sp, "cpu"),
                                 torch.tensor(xs)),
           jcnn.forward_im2col_k(sp, jnp.asarray(xs)))
    want = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0)))
    got = tcnn.init_cnn(0, "cpu")
    for layer in want:
        for leaf in want[layer]:
            assert tuple(got[layer][leaf].shape) == want[layer][leaf].shape
            assert got[layer][leaf].dtype == torch.float32
    again = tcnn.init_cnn(0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(again)))
    for cut in range(6):
        ue, bs = tcnn.split_params(tp, cut)
        jue, jbs = jcnn.split_params(params, cut)
        assert sorted(ue) == sorted(jue) and sorted(bs) == sorted(jbs)
        assert tcnn.merge_params(ue, bs).keys() == tp.keys()


def test_policy_validation_and_unported_options():
    """Validation raises what the reference's raises, and every option the
    reference accepts (bf16, the single-user kernels, im2col; formerly
    unported) runs: f32 losses (K,) and f32 grads of the params' shapes.
    Their parity with the reference is in ``tests/test_torch_policy*.py``."""
    with pytest.raises(ValueError, match="kernel"):
        ForwardPolicy(kernel="cuda").validate()
    with pytest.raises(ValueError, match="precision"):
        ForwardPolicy(precision="fp8").validate()
    with pytest.raises(ValueError, match="block_k"):
        ForwardPolicy(block_k=-1).validate()
    params, x, y = _cohort(3)
    tp = params_from_numpy(params, "cpu")
    for kernel in ops.KERNELS:
        for precision in ops.PRECISIONS:
            for users in (True, False):
                pol = ForwardPolicy(kernel=kernel, precision=precision,
                                    batch_users=users)
                loss, g = make_stacked_loss_grad(pol)(tp, torch.tensor(x),
                                                      torch.tensor(y))
                assert loss.shape == (3,) and loss.dtype == torch.float32
                assert bool(torch.isfinite(loss).all())
                for gg, pp in zip(tree_leaves(g), tree_leaves(tp)):
                    assert gg.dtype == torch.float32
                    assert gg.shape == pp.shape
    # both reference kernel names run the port's one path; block_k is a
    # validated no-op
    base = make_stacked_loss_grad(ForwardPolicy())(tp, torch.tensor(x),
                                                   torch.tensor(y))
    for pol in (ForwardPolicy(kernel="pallas"), ForwardPolicy(block_k=2)):
        got = make_stacked_loss_grad(pol)(tp, torch.tensor(x),
                                          torch.tensor(y))
        np.testing.assert_array_equal(_np(got[0]), _np(base[0]))


def test_wrappers_reject_tensors_off_cpu_and_cuda():
    x = torch.empty((1, 1, 4, 4, 1), device="meta")
    w = torch.empty((1, 3, 3, 1, 2), device="meta")
    b = torch.empty((1, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tknl.conv_pool_fwd_k(x, w, b)


def test_twin_fold_is_the_transpose_of_patches():
    """<patches(x), d> == <x, fold(d)>: fold3x3 is the adjoint the conv
    backward's image gradient needs."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 6, 6, 3)), dtype=torch.float64)
    d = torch.tensor(rng.standard_normal((2, 6, 6, 27)), dtype=torch.float64)
    lhs = torch.sum(tref.patches3x3(x) * d)
    rhs = torch.sum(x * tref.fold3x3(d))
    assert abs(float(lhs - rhs)) < 1e-9


@pytest.mark.parametrize("d1", [10, 16, 100, 128, 300])
def test_fc_fwd_tiling_covers_every_output_once(d1):
    """The fc forward kernel's grid (ceil(D1/cols), ceil(B/rows), K) with
    blocks of ``rows`` x ``cols`` outputs of layer 1 (the last tile of
    each axis ragged) covers every (user, row, column) exactly once, and
    a tile never exceeds what the kernel holds (16 rows x 16 columns: a
    thread per two rows of one column, 128 threads)."""
    for k in (1, 3, 10):
        for bs in (1, 2, 7, 10, 16, 17, 100, 1000):
            rows, cols = tknl.fc_fwd_tiling(k, bs, d1)
            assert 1 <= rows <= tknl.FC_FWD_MAX_ROWS
            assert 1 <= cols <= tknl.FC_FWD_MAX_COLS
            assert -(-rows // 2) * cols <= 128
            hits = np.zeros((k, bs, d1), np.int64)
            for z in range(k):
                for y in range(-(-bs // rows)):
                    for x in range(-(-d1 // cols)):
                        r0, c0 = y * rows, x * cols
                        hits[z, r0:min(r0 + rows, bs),
                             c0:min(c0 + cols, d1)] += 1
            assert (hits == 1).all(), (k, bs, d1, rows, cols)
