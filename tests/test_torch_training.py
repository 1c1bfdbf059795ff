"""The zoo's training path on the CPU against the JAX package.

The JAX init (and its ``TrainState``) goes across through
``repro_torch.convert``; the same numpy batches (``models.inputs``'
``materialize``) go through the reference's jitted ``make_train_step``
and the port's.  Both train through the reference's einsum paths:
``_sdpa`` (``_sdpa_chunked`` above 1024 tokens) and ``wkv_scan``; the
kernels, which have no backward in either package, are refused where
autograd records.

Tolerances (f32, the zoo's rule):
- loss: 1e-5 relative, every step;
- params and optimizer state after each of 1 sgd + 3 adamw steps (clip
  1.0), from the same state: 1e-4 of the largest magnitude in the tree.
  The grads differ by summation order only (1e-7 to 1e-5 relative); AdamW
  divides each by its own root mean square, so an element whose grad is
  within rounding of zero may move by up to 2 lr more on one side;
- ``_sdpa_chunked`` values and grads, and the fused head's loss and grads:
  1e-5 of the largest magnitude (summation order only);
- remat none/full/dots, the two forms of mamba's scan, checkpoints and a
  resumed launcher: bitwise (one thread: the CPU's embedding backward
  accumulates in thread order).
"""
import functools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import base as j_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import inputs as j_inputs  # noqa: E402
from repro.training import create_train_state as j_create_state  # noqa: E402
from repro.training import loss_fn as j_loss_fn  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro.training.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.convert import (params_from_numpy, state_from_numpy,  # noqa: E402
                                 state_to_numpy)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.models import attention, build_model, inputs, mamba  # noqa: E402
from repro_torch.training import (TrainState, create_train_state,  # noqa: E402
                                  make_train_step)
from repro_torch.training.step import value_and_grad  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
GRAD_RTOL = 1e-5
B, S = 2, 16


def _jcfg(cfg):
    return j_configs.ModelConfig(**vars(cfg))


def _cfg(arch: str):
    return configs.get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _jparams(arch: str):
    return j_build_model(_jcfg(_cfg(arch))).init(jax.random.PRNGKey(0))


def _batches(cfg, s=S, seed=1):
    """The same train batch from both packages' ``materialize``."""
    spec = inputs.train_specs(cfg, B, s)
    return (j_inputs.materialize(j_inputs.train_specs(_jcfg(cfg), B, s),
                                 _jcfg(cfg), seed=seed),
            inputs.materialize(spec, cfg, seed=seed, device="cpu"))


def _np(tree):
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in jax.tree_util.tree_leaves(tree)]


def _tnp(tree):
    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def _within(got, want, rtol):
    """Every leaf within ``rtol`` of the largest magnitude in ``want``."""
    scale = max(float(np.abs(a).max()) for a in want)
    err = max(float(np.abs(b - a).max()) for a, b in zip(want, got))
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_steps_match_jax(arch):
    """1 sgd + 3 adamw steps (clip 1.0), each from the JAX state of the
    step before converted (``state_from_numpy``): every loss within 1e-5,
    the new params and optimizer state within 1e-4 of the largest
    magnitude.  Each step starts from the reference's state because f32
    trajectories fork: AdamW's first steps are nearly sign steps, so a
    grad within rounding of zero moves its param by +-lr on either side,
    and rwkv6's grads carry ~1e-5 of rounding (both packages, against a
    float64 run).  The reference forks from itself too: its jitted and
    its eager rwkv6 runs are 1.7e-4 apart in the loss after two AdamW
    steps, the port and the jitted run 1.9e-4 (``scripts/train_fork.py``)."""
    cfg = _cfg(arch)
    jm, tm = j_build_model(_jcfg(cfg)), build_model(cfg, "cpu")
    jb, tb = _batches(cfg)
    runs = ((j_optim.sgd(5e-2), optim.sgd(5e-2), 1),
            (j_optim.adamw(j_optim.cosine(3e-4, 1, 3), weight_decay=0.1),
             optim.adamw(optim.cosine(3e-4, 1, 3), weight_decay=0.1), 3))
    jparams = _jparams(arch)
    for j_opt, t_opt, steps in runs:
        js = j_create_state(jparams, j_opt)
        j_step = jax.jit(j_make_train_step(jm, j_opt, grad_clip=1.0))
        t_step = make_train_step(tm, t_opt, grad_clip=1.0)
        for _ in range(steps):
            ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                  "cpu")
            for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            js, jmet = j_step(js, jb)
            ts, tmet = t_step(ts, tb)
            for key in ("loss", "ce", "aux"):
                assert isinstance(tmet[key], torch.Tensor)
                np.testing.assert_allclose(float(tmet[key]),
                                           float(jmet[key]),
                                           rtol=LOSS_RTOL, atol=1e-7)
            _within(_tnp(ts.params), _np(js.params), PARAM_RTOL)
            _within(_tnp(ts.opt_state), _np(js.opt_state), PARAM_RTOL)
            assert int(ts.step) == int(js.step)
            assert int(ts.opt_state["step"]) == int(js.opt_state["step"])
        jparams = js.params
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts.params))


def test_loss_fn_matches_jax_and_every_leaf_gets_a_grad():
    cfg = _cfg("granite-moe-3b-a800m")
    jm, tm = j_build_model(_jcfg(cfg)), build_model(cfg, "cpu")
    jb, tb = _batches(cfg)
    jp = _jparams("granite-moe-3b-a800m")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    (want, jparts), jg = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb), has_aux=True)(jp)
    (got, tparts), tg = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tparts["aux"]), float(jparts["aux"]),
                               rtol=LOSS_RTOL)
    assert float(got) != float(tparts["ce"])       # router_aux_coef x aux
    _within(_tnp(tg), _np(jg), GRAD_RTOL)
    assert all(bool((g != 0).any()) for g in tree_leaves(tg))


def _chunk_cfg(kind: str):
    if kind == "bidirectional":
        return _cfg("hubert-xlarge")
    cfg = _cfg("llama3.2-1b").replace(num_kv_heads=2)
    return cfg.with_sliding_window(64) if kind == "window64" else cfg


@pytest.mark.parametrize("kind", ["causal", "window64", "bidirectional"])
def test_sdpa_chunked_matches_jax(kind):
    """S=1280 (five 256-row q chunks): values and the grads of q, k, v
    under one random cotangent."""
    cfg = _chunk_cfg(kind)
    rng = np.random.default_rng(11)
    s, h, kv, d = 1280, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((1, s, h, d), (1, s, kv, d), (1, s, kv, d),
                                 (1, s, h * d)))
    want, vjp = jax.vjp(lambda a, b, c: j_attn._sdpa_chunked(_jcfg(cfg), a, b,
                                                             c),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = attention._sdpa_chunked(cfg, tq, tk, tv)
    got.backward(torch.from_numpy(ct))
    _within([got.detach().numpy()], [np.asarray(want)], GRAD_RTOL)
    for a, b in zip(jgrads, (tq, tk, tv)):
        _within([b.grad.numpy()], [np.asarray(a)], GRAD_RTOL)


def test_attend_full_takes_the_reference_paths_under_autograd(monkeypatch):
    """Under autograd ``impl="xla"`` takes ``_sdpa_chunked`` where S > 1024
    and S % 256 == 0, else ``_sdpa``; in inference the kernel wrapper."""
    cfg = _cfg("llama3.2-1b")
    tm = build_model(cfg, "cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jparams("llama3.2-1b")), "cpu")
    seen = []
    for name in ("_sdpa", "_sdpa_chunked"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name, functools.partial(
            lambda fn, name, *a: (seen.append(name), fn(*a))[1], fn, name))
    kernel = attention.fa_ops.flash_attention
    monkeypatch.setattr(attention.fa_ops, "flash_attention",
                        lambda *a, **kw: (seen.append("kernel"),
                                          kernel(*a, **kw))[1])
    for s, want in ((1280, "_sdpa_chunked"), (1100, "_sdpa"),
                    (1024, "_sdpa")):
        tb = inputs.materialize(inputs.train_specs(cfg, 1, s), cfg, seed=2,
                                device="cpu")
        seen.clear()
        value_and_grad(tm, tp, tb)
        assert seen == [want] * cfg.num_layers, (s, seen)
    seen.clear()
    with torch.no_grad():
        tm.forward(tp, tb)
    assert seen == ["kernel"] * cfg.num_layers


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3-405b"],
                         ids=["tied", "untied"])
def test_fused_head_matches_jax(arch):
    """S=1024: two 512-position chunks.  Loss and grads against the
    reference's fused head, and the loss against the standard CE."""
    cfg = _cfg(arch)
    jm, tm = j_build_model(_jcfg(cfg)), build_model(cfg, "cpu")
    jb, tb = _batches(cfg, s=1024, seed=4)
    jp = _jparams(arch)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    opts = {"fused_head": True}
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, opts), has_aux=True))(jp)
    (got, _), tg = value_and_grad(tm, tp, tb, opts)
    (std, _), _ = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got), float(std), rtol=LOSS_RTOL)
    _within(_tnp(tg), _np(jg), GRAD_RTOL)


@pytest.mark.parametrize("arch,s", [("llama3.2-1b", 16), ("llama3.2-1b", 1280),
                                    ("hymba-1.5b", 16), ("rwkv6-7b", 16),
                                    ("granite-moe-3b-a800m", 16)])
def test_remat_gives_the_same_loss_and_grads(arch, s):
    cfg = _cfg(arch)
    tm = build_model(cfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    tb = inputs.materialize(inputs.train_specs(cfg, 1, s), cfg, seed=3,
                            device="cpu")
    (loss, _), grads = value_and_grad(tm, tp, tb)
    for remat in ("full", "dots"):
        (l2, _), g2 = value_and_grad(tm, tp, tb, {"remat": remat})
        assert float(l2) == float(loss), remat
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                     tree_leaves(g2))), remat
    with pytest.raises(ValueError, match="remat"):
        tm.forward(tp, tb, {"remat": "some"})


def test_kernel_wrappers_refuse_autograd():
    """No gradient is cut silently: the forward-only kernels raise where
    autograd would record, and run under no_grad."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 8, 32, generator=g) for _ in range(3))
    r, kk, vv = (torch.randn(4, 8, 32, generator=g) for _ in range(3))
    w, u = torch.rand(4, 8, 32, generator=g), torch.randn(4, 32, generator=g)
    for grad_of in range(3):
        args = [t.clone().requires_grad_(i == grad_of)
                for i, t in enumerate((q, k, v))]
        with pytest.raises(RuntimeError, match="no backward"):
            fa_kernel.flash_attention_bh(*args)
        with torch.no_grad():
            fa_kernel.flash_attention_bh(*args)
    for grad_of in range(5):
        args = [t.clone().requires_grad_(i == grad_of)
                for i, t in enumerate((r, kk, vv, w, u))]
        with pytest.raises(RuntimeError, match="no backward"):
            wkv_kernel.wkv6_bh(*args)
        with torch.no_grad():
            wkv_kernel.wkv6_bh(*args)
    fa_kernel.flash_attention_bh(q, k, v)            # nothing needs a grad
    wkv_kernel.wkv6_bh(r, kk, vv, w, u)


@pytest.mark.parametrize("arch,opts", [
    ("llama3.2-1b", {"impl": "flash"}),
    ("rwkv6-7b", {"wkv_impl": "wkv6_kernel"})])
def test_kernel_impls_raise_under_autograd(arch, opts):
    """The reference's jax.grad through its kernels fails; so does the
    port's, with the reason, while inference takes them as before."""
    cfg = _cfg(arch)
    tm = build_model(cfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    tb = inputs.materialize(inputs.train_specs(cfg, B, S), cfg, seed=3,
                            device="cpu")
    step = make_train_step(tm, optim.sgd(0.1), opts)
    with pytest.raises(NotImplementedError, match="no backward"):
        step(create_train_state(tp, optim.sgd(0.1)), tb)
    with torch.no_grad():
        logits, _ = tm.forward(tp, tb, opts)
    assert bool(torch.isfinite(logits).all())


def test_mamba_scan_forms_are_bitwise_equal():
    """The autograd form (a new tensor a step, stacked) and the inference
    form (``out=`` into one buffer) of ``selective_scan``: two chunks of
    SCAN_CHUNK steps and a ragged third."""
    g = torch.Generator().manual_seed(5)
    b_, s, di, n = 2, 2 * mamba.SCAN_CHUNK + 7, 24, 8
    dt = torch.rand(b_, s, di, generator=g) * 0.1
    Bm, Cm = (torch.randn(b_, s, n, generator=g) for _ in range(2))
    xf = torch.randn(b_, s, di, generator=g)
    A = -torch.exp(torch.randn(di, n, generator=g))
    with torch.no_grad():
        want = mamba.selective_scan(dt, Bm, Cm, xf, A)
    x_grad = xf.clone().requires_grad_()
    got = mamba.selective_scan(dt, Bm, Cm, x_grad, A)
    assert got.requires_grad and torch.equal(got.detach(), want)
    got.sum().backward()
    assert bool(torch.isfinite(x_grad.grad).all())


@pytest.mark.parametrize("opt_sync", [False, True])
def test_train_state_checkpoints_cross_packages(opt_sync, tmp_path):
    """A JAX TrainState (adamw moments after one step) saved by the
    reference restores in the port, and the port's restores in JAX."""
    cfg = _cfg("llama3.2-1b")
    jm = j_build_model(_jcfg(cfg))
    jb, _ = _batches(cfg)
    j_opt = j_optim.adamw(1e-3)
    js = j_create_state(_jparams("llama3.2-1b"), j_opt,
                        with_opt_sync=opt_sync, tau_extra0=0.5)
    js, _ = jax.jit(j_make_train_step(jm, j_opt))(js, jb)
    j_save(str(tmp_path / "jax"), 1, js)
    t_opt = optim.adamw(1e-3)
    like = create_train_state(build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(9)), t_opt, with_opt_sync=opt_sync)
    got = restore_checkpoint(str(tmp_path / "jax"), 1, like)
    assert isinstance(got, TrainState)
    assert (got.snapshot is None) == (not opt_sync)
    want = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(js))
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_checkpoint(str(tmp_path / "port"), 1, got)
    back = j_restore(str(tmp_path / "port"), 1, js)
    assert isinstance(back, JTrainState)
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    mirror = JTrainState(*(None if f is None else jax.tree_util.tree_map(
        jnp.asarray, f) for f in state_to_numpy(got)))
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(mirror)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_tree_map_walks_a_train_state():
    st = create_train_state({"w": torch.ones(2)}, optim.sgd(0.1))
    doubled = tree_map(lambda t: t * 2, st)
    assert isinstance(doubled, TrainState) and doubled.snapshot is None
    assert torch.equal(doubled.params["w"], torch.full((2,), 2.0))
    assert int(doubled.step) == 0 and doubled.step.dtype == torch.int32


def test_train_launcher_resumes_to_the_uninterrupted_run(tmp_path, capsys):
    """4 steps in one run against 2 steps, a restart from the step-2
    checkpoint and 2 more: the step-4 checkpoints are equal byte for
    byte (params, moments, steps)."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--reduced", "--arch", "llama3.2-1b",
            "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-every",
            "2", "--log-every", "1"]
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    assert train.main(argv + ["--ckpt-dir", str(whole)]) == 0
    shutil.copytree(whole / "2", resumed / "2")
    capsys.readouterr()
    assert train.main(argv + ["--ckpt-dir", str(resumed)]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "step 3/4" in out
    assert "step 1/4" not in out
    assert ((whole / "4" / "checkpoint.msgpack").read_bytes()
            == (resumed / "4" / "checkpoint.msgpack").read_bytes())
    assert train.main(argv + ["--ckpt-dir", str(resumed)]) == 0
    assert "nothing to train" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-vl-2b",
                                  "granite-moe-3b-a800m"])
def test_train_launcher_runs_every_family_kind(arch, capsys):
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--steps", "2", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "done: final loss" in out


def test_training_entry_points_refuse_to_run_without_a_card(monkeypatch):
    import importlib

    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    for name in ("quickstart", "serve_batched", "uav_fl_sim"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--rounds", "1"] if name == "uav_fl_sim" else [])
