"""The port's optimizers, schedules, token data and split helpers against
the JAX package, on the same numpy inputs.

Tolerances:
- sgd (with and without momentum): bitwise.  Each update is one f32
  product and one sum per element, in the reference's order, and JAX runs
  eagerly here (op by op, no fusion).
- adamw: 1e-6 of the largest magnitude, per step.  The moments are bitwise
  (products and sums only); the update divides by the bias corrections,
  whose ``b ** step`` (and the square root) XLA's CPU code may round
  otherwise than torch's.
- clip_by_global_norm: 1e-6 relative (the squares are summed in another
  order inside each leaf); unclipped grads come back bitwise.
- constant and cosine: 1e-6 relative (torch's and XLA's cos may differ by
  an ulp).
- make_token_stream, batches, split/merge and ue_param_bytes: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.configs import base as j_configs  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.data import batches as j_batches  # noqa: E402
from repro.data import make_token_stream as j_make_token_stream  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.data import (batches, epoch_count_steps,  # noqa: E402
                              make_digits, make_token_stream)
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

ADAM_RTOL = 1e-6


def _tree(seed: int, scale: float = 1.0):
    """A param-shaped tree of numpy f32 leaves: nested dicts, a vector, a
    matrix and a 3-d leaf (weight decay applies to ndim >= 2)."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"dense": {"w": draw(8, 16), "b": draw(16)},
            "conv": draw(3, 4, 5), "scale": draw(7)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np_leaves(tree):
    """Leaves as f32 numpy, from either package (bf16 widened)."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return [t.float().numpy() for t in tree_leaves(tree)]
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in jax.tree_util.tree_leaves(tree)]


def _run(j_opt, t_opt, steps: int):
    """``steps`` updates from one start in both packages; returns the
    (params, opt state) of each after every step."""
    p_np = _tree(0)
    jp, tp = _j(p_np), params_from_numpy(p_np, "cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    out = []
    for i in range(steps):
        g_np = _tree(100 + i, scale=0.1)
        ju, js = j_opt.update(_j(g_np), js, jp)
        tu, ts = t_opt.update(params_from_numpy(g_np, "cpu"), ts, tp)
        jp, tp = j_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        out.append(((jp, js), (tp, ts)))
    return out


@pytest.mark.parametrize("lr", ["float", "constant"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_is_bitwise_equal_to_jax(momentum, lr):
    rate = 0.05
    j_lr = rate if lr == "float" else j_optim.constant(rate)
    t_lr = rate if lr == "float" else optim.constant(rate)
    for (jp, js), (tp, ts) in _run(j_optim.sgd(j_lr, momentum),
                                   optim.sgd(t_lr, momentum), 5):
        for a, b in zip(_np_leaves(jp), _np_leaves(tp)):
            np.testing.assert_array_equal(b, a)
        if momentum:
            for a, b in zip(_np_leaves(js["mu"]), _np_leaves(ts["mu"])):
                np.testing.assert_array_equal(b, a)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_jax_each_step(moments, wd):
    j_opt = j_optim.adamw(j_optim.cosine(1e-2, 2, 5), weight_decay=wd,
                          moment_dtype=getattr(jnp, moments))
    t_opt = optim.adamw(optim.cosine(1e-2, 2, 5), weight_decay=wd,
                        moment_dtype=getattr(torch, moments))
    for (jp, js), (tp, ts) in _run(j_opt, t_opt, 5):
        for a, b in zip(_np_leaves(jp), _np_leaves(tp)):
            err = np.abs(b - a).max()
            assert err <= ADAM_RTOL * np.abs(a).max(), err
        for key in ("m", "v"):
            assert all(t.dtype == getattr(torch, moments)
                       for t in tree_leaves(ts[key]))
            for a, b in zip(_np_leaves(js[key]), _np_leaves(ts[key])):
                np.testing.assert_array_equal(b, a)
        assert int(ts["step"]) == int(js["step"])


def test_adamw_decays_only_matrices():
    """Weight decay touches the leaves of two or more dims: with zero
    grads a vector stays put and a matrix shrinks."""
    opt = optim.adamw(0.1, weight_decay=0.5)
    p = params_from_numpy(_tree(3), "cpu")
    upd, _ = opt.update(tree_map(torch.zeros_like, p), opt.init(p), p)
    assert torch.equal(upd["scale"], torch.zeros(7))
    torch.testing.assert_close(upd["dense"]["w"], -0.05 * p["dense"]["w"],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [10.0, 1e-3], ids=["clipped", "kept"])
def test_clip_by_global_norm_matches_jax(scale):
    g = _tree(7, scale=scale)
    want = _np_leaves(j_optim.clip_by_global_norm(_j(g), 1.0))
    got = _np_leaves(optim.clip_by_global_norm(params_from_numpy(g, "cpu"),
                                               1.0))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    if scale < 1:
        for a, b in zip(_np_leaves(_j(g)), got):
            np.testing.assert_array_equal(b, a)


def test_schedules_match_jax():
    steps = torch.arange(0, 14, dtype=torch.int32)
    for j_fn, t_fn in ((j_optim.constant(3e-4), optim.constant(3e-4)),
                       (j_optim.cosine(1.0, 10, 100),
                        optim.cosine(1.0, 10, 100)),
                       (j_optim.cosine(3e-4, 2, 12, floor=1e-5),
                        optim.cosine(3e-4, 2, 12, floor=1e-5))):
        for s in steps:
            want = float(j_fn(jnp.asarray(int(s), jnp.int32)))
            got = t_fn(s)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-12)


def test_token_stream_and_batches_equal_jax():
    for n, s, v, seed in ((16, 32, 100, 0), (8, 64, 512, 3)):
        want, got = j_make_token_stream(n, s, v, seed), make_token_stream(
            n, s, v, seed)
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
        assert got.x.dtype == np.int32 and np.all(got.x[:, 1:] == got.y[:, :-1])
        for (xa, ya), (xb, yb) in zip(j_batches(want, 5, seed=1),
                                      batches(got, 5, seed=1)):
            np.testing.assert_array_equal(xb, xa)
            np.testing.assert_array_equal(yb, ya)
    ds = make_digits(7, seed=0)
    assert [len(x) for x, _ in batches(ds, 10)] == [7]
    assert epoch_count_steps(ds, 10) == 1 and epoch_count_steps(ds, 3) == 2


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_split_merge_round_trip_and_ue_bytes(cut):
    cfg = configs.get_config("llama3.2-1b").reduced()
    jp = j_build_model(j_configs.ModelConfig(**vars(cfg))).init(
        jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    (j_ue, j_bs), (t_ue, t_bs) = j_split.split_stacked(jp, cut), \
        split.split_stacked(tp, cut)
    for a, b in zip(_np_leaves((j_ue, j_bs)), _np_leaves((t_ue, t_bs))):
        np.testing.assert_array_equal(b, a)
    merged = split.merge_stacked(t_ue, t_bs)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(merged),
                                                 tree_leaves(tp)))
    assert split.ue_param_bytes(tp, cut) == j_split.ue_param_bytes(jp, cut)
    assert split.ue_param_bytes({"w": torch.zeros(3, 2)}, cut) == 24
