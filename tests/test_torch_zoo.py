"""The model zoo's inference path (dense and ssm families) on the CPU
against the JAX package.

The JAX init goes across through ``repro_torch.convert``; the same numpy
tokens go through the reference's ``forward_full`` with ``impl="flash"`` and
``wkv_impl="wkv6_kernel"`` (its Pallas kernels switched to interpret mode
by monkeypatching its ``ops`` wrappers, nothing in ``repro`` edited) and
through the port on the CPU, where the kernel wrappers run their twins.
Models: Llama-3.2-1B reduced with 2 kv heads (GQA, G=2), its 64-token
sliding-window variant, and RWKV6-7B reduced; B=2, S=128.

Tolerances:
- f32 logits: 1e-4 of the largest magnitude.  Measured below 3e-6: the
  twins and the port's torch ops sum in another order.
- bf16 logits: relative Frobenius error 3%.  Measured 0.9% (llama, both
  variants) and 1.2% (rwkv6) for the full forward, 0.9% and 1.6% for the
  cache path; the reference's own einsum and kernel paths are 1.0% and
  0.5% apart.  Each layer alone, from identical inputs, is within 5e-4:
  bf16 products summed in another order round a few values to the
  neighbouring bf16 (0.1-2.5% of the elements), and the residual stream
  carries those one-ulp differences through the later roundings.  The
  sigmoid follows XLA's lowering step for step (``layers.sigmoid``); with
  ``torch.sigmoid`` rwkv6's time-mix alone was 0.4% apart.
- greedy tokens at f32: equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.flash_attention.ops as j_fa_ops  # noqa: E402
import repro.kernels.wkv6.ops as j_wkv_ops  # noqa: E402
from repro.configs import base as j_configs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.rope import rope_angles as j_rope_angles  # noqa: E402
from repro.serving.decode import generate as j_generate  # noqa: E402
from repro.serving.decode import prefill as j_prefill  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base as t_configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.models import build_model, module  # noqa: E402
from repro_torch.models.rope import rope_angles  # noqa: E402
from repro_torch.serving import generate, prefill  # noqa: E402
from repro_torch.training.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

F32_RTOL = 1e-4
BF16_FROB = 0.03
KERNEL_OPTS = {"impl": "flash", "wkv_impl": "wkv6_kernel"}


@pytest.fixture(autouse=True)
def interpret_kernels(monkeypatch):
    """The reference's Pallas kernels in interpret mode (the CPU backend
    runs no other), through its own ``ops`` wrappers."""
    monkeypatch.setattr(j_fa_ops, "flash_attention",
                        functools.partial(j_fa_ops.flash_attention,
                                          interpret=True))
    monkeypatch.setattr(j_wkv_ops, "wkv6",
                        functools.partial(j_wkv_ops.wkv6, interpret=True))


def _cfg(name: str, dtype: str = "float32"):
    if name == "rwkv6":
        cfg = configs.get_config("rwkv6-7b").reduced()
    else:
        cfg = configs.get_config("llama3.2-1b").reduced().replace(
            num_kv_heads=2)
        if name == "llama-sw64":
            cfg = cfg.with_sliding_window(64)
    return cfg.replace(dtype=dtype)


MODELS = ["llama-gqa2", "llama-sw64", "rwkv6"]


@functools.lru_cache(maxsize=None)
def _params(name: str):
    """One JAX init per model (params are f32 at either compute dtype)."""
    jm = j_build_model(j_configs.ModelConfig(**vars(_cfg(name))))
    jp = jm.init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _models(name: str, dtype: str):
    """(jax model, jax params, port model, port params)."""
    cfg = _cfg(name, dtype)
    jp, tp = _params(name)
    return (j_build_model(j_configs.ModelConfig(**vars(cfg))), jp,
            build_model(cfg, "cpu"), tp)


def _tokens(cfg, b=2, s=128, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check(got: torch.Tensor, want: np.ndarray, dtype: str):
    got = got.float().numpy()
    if dtype == "float32":
        err = float(np.abs(got - want).max())
        assert err <= F32_RTOL * float(np.abs(want).max()), err
    else:
        frob = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert frob <= BF16_FROB, frob


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_full_matches_jax_kernel_path(name, dtype):
    jm, jp, tm, tp = _models(name, dtype)
    toks = _tokens(tm.cfg)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, KERNEL_OPTS)
    for opts in (KERNEL_OPTS, None):      # "xla" names the same path here
        got = make_prefill_step(tm, opts)(tp,
                                          {"tokens": torch.from_numpy(toks)})
        assert got.dtype == module.dtype_of(dtype)
        assert tuple(got.shape) == (2, 128, tm.cfg.vocab_padded)
        _check(got, _np(want), dtype)
    hidden, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                             {"return_hidden": True})
    assert tuple(hidden.shape) == (2, 128, tm.cfg.d_model) and float(aux) == 0


# the 64-token window exceeds these contexts: the plain llama's cache path
CACHE_MODELS = ["llama-gqa2", "rwkv6"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CACHE_MODELS)
def test_prefill_and_decode_step_match_jax(name, dtype):
    """The cache-exact token loop (``prefill``) and one more
    ``decode_step`` against the reference's: logits and carried state."""
    jm, jp, tm, tp = _models(name, dtype)
    toks = _tokens(tm.cfg, s=12, seed=2)
    ctx = 16
    jl, jst, jpos = j_prefill(jm, jp, jnp.asarray(toks), context_len=ctx)
    tl, tst, tpos = prefill(tm, tp, torch.from_numpy(toks), context_len=ctx)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    _check(tl, _np(jl), dtype)
    for a, b in zip(tree_leaves(tst), jax.tree_util.tree_leaves(jst)):
        assert tuple(a.shape) == b.shape
        _check(a, _np(b), dtype)
    nxt = np.full((2, 1), 7, np.int32)
    jl2, _ = jm.decode(jp, jnp.asarray(nxt), jst, jpos)
    tl2, _ = make_decode_step(tm)(tp, torch.from_numpy(nxt), tst, tpos)
    _check(tl2, _np(jl2), dtype)


@pytest.mark.parametrize("name", CACHE_MODELS)
def test_greedy_generate_tokens_equal_jax(name):
    jm, jp, tm, tp = _models(name, "float32")
    toks = _tokens(tm.cfg, s=10, seed=3)
    want = np.asarray(j_generate(jm, jp, jnp.asarray(toks), max_new=8,
                                 context_len=18))
    got = generate(tm, tp, torch.from_numpy(toks), max_new=8, context_len=18)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", MODELS)
def test_kernel_path_matches_cache_path(name):
    """The reference's ``test_decode_matches_full_forward`` on the port:
    the full forward's last logits equal the token loop's."""
    _, _, tm, tp = _models(name, "float32")
    toks = torch.from_numpy(_tokens(tm.cfg, s=12, seed=4))
    full, _ = tm.forward(tp, {"tokens": toks})
    last, _, _ = prefill(tm, tp, toks, context_len=12)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


def test_sampled_generate_follows_its_generator():
    _, _, tm, tp = _models("rwkv6", "float32")
    toks = torch.from_numpy(_tokens(tm.cfg, s=6, seed=5))
    draw = lambda seed: generate(
        tm, tp, toks, max_new=6, context_len=12, temperature=0.8,
        gen=torch.Generator().manual_seed(seed))
    a, b = draw(0), draw(0)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 6)
    assert int(a.max()) < tm.cfg.vocab_padded and int(a.min()) >= 0


def test_forward_full_launches_no_kernel_on_the_cpu():
    """On CPU tensors every wrapper runs its twin: no launch is counted."""
    fa_kernel.reset_launches()
    wkv_kernel.reset_launches()
    for name in ("llama-gqa2", "rwkv6"):
        _, _, tm, tp = _models(name, "float32")
        tm.forward(tp, {"tokens": torch.from_numpy(_tokens(tm.cfg, s=8))})
    assert fa_kernel.LAUNCHES == {"flash_attention_bh": 0}
    assert wkv_kernel.LAUNCHES == {"wkv6_bh": 0}


@pytest.mark.parametrize("name", ["llama-gqa2", "rwkv6"])
def test_param_tree_matches_the_reference_layout(name):
    """The port's own init has the reference's keys, shapes and dtypes
    (stacked (L, ...) leaves), so checkpoints and converted params fit."""
    jm, jp, tm, _ = _models(name, "float32")
    own = tm.init(torch.Generator().manual_seed(0))
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)
    t_leaves = tree_leaves(own)
    assert len(j_leaves) == len(t_leaves)
    for (path, a), b in zip(j_leaves, t_leaves):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
    assert module.param_count(own) == sum(a.size for _, a in j_leaves)
    again = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(t_leaves,
                                                 tree_leaves(again)))


def test_configs_are_the_reference_configs():
    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    for arch in configs.ARCH_IDS + ("paper-cnn",):
        cfg = configs.get_config(arch)
        assert vars(cfg) == vars(j_configs.get_config(arch)), arch
        assert vars(cfg.reduced()) == vars(
            j_configs.get_config(arch).reduced()), arch
        assert cfg.param_count() == j_configs.get_config(arch).param_count()
        for kind in ("train", "prefill"):
            assert t_configs.tuned_opts(cfg, kind) == j_configs.tuned_opts(
                j_configs.get_config(arch), kind)
    assert {k: vars(v) for k, v in configs.INPUT_SHAPES.items()} == {
        k: vars(v) for k, v in j_configs.INPUT_SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("sections", [(), (4, 6, 6)], ids=["rope", "mrope"])
def test_rope_angles_match_jax(sections):
    rng = np.random.default_rng(6)
    shape = (2, 3, 9) if sections else (2, 9)
    pos = rng.integers(0, 500, shape).astype(np.int32)
    want = np.asarray(jax.jit(j_rope_angles, static_argnums=(1, 2, 3))(
        jnp.asarray(pos), 32, 10_000.0, sections))
    got = rope_angles(torch.from_numpy(pos), 32, 10_000.0, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_cnn_family_wraps_the_paper_model():
    cfg = configs.get_config("paper-cnn")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    logits, aux = model.forward(params, {"images": torch.zeros(2, 28, 28, 1)})
    assert tuple(logits.shape) == (2, 10) and aux == 0.0
    assert model.decode is None and model.param_count(params) == 110_634


def test_opts_outside_the_slice_raise():
    """An impl the port does not have raises; the training opts (remat,
    fused_head) run and leave the forward's logits as they are."""
    _, _, tm, tp = _models("llama-gqa2", "float32")
    toks = {"tokens": torch.from_numpy(_tokens(tm.cfg, s=4))}
    with pytest.raises(ValueError, match="impl"):
        tm.forward(tp, toks, {"impl": "einsum"})
    with pytest.raises(ValueError, match="unknown opts"):
        tm.forward(tp, toks, {"no_such_opt": True})
    want, _ = tm.forward(tp, toks)
    for opts in ({"remat": "full"}, {"remat": "dots"}, {"fused_head": True}):
        got, _ = tm.forward(tp, toks, opts)
        assert torch.equal(got, want), opts
    tm.forward(tp, toks, {"act_sharding": None, "unroll_layers": True,
                          "moe_dispatch": "dense"})


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b"])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--batch", "2", "--prompt-len", "5", "--max-new",
                       "4"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "generated 8 tokens" in out
