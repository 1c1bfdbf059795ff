"""The zoo's moe, hybrid, vlm and audio families for inference on the CPU
against the JAX package.

As in ``test_torch_zoo.py``: the JAX init goes across through
``repro_torch.convert``, the reference runs its flash-attention kernel
(``impl="flash"``) in interpret mode through its monkeypatched ``ops``
wrapper (nothing in ``repro`` edited), and the port runs its twins on CPU
tensors.  Inputs come from each package's ``inputs.materialize`` with one
seed: tokens, and the stub frontends' frame embeddings (hubert), patch
embeddings and M-RoPE positions (qwen2-vl).  Models, reduced: granite-moe
(4 experts, top-2) and hymba with 2 kv heads (GQA kept, G = 2),
qwen2-vl (4 q / 2 kv, M-RoPE (4, 6, 6), 16 patches), hubert-xlarge
(bidirectional, no embedding table) and llama4-maverick (4 experts,
top-1); B = 2, S = 128.

Tolerances:
- f32 logits: 1e-4 of the largest magnitude of the real vocabulary
  (the padded slots hold -1e9); measured below 2e-6.  Aux: 1e-6.
- bf16 logits: 3% relative Frobenius; measured 0.8-2.0%.  A bf16 router
  logit that rounds the other way may move one token's k-th expert
  (granite, dense: one token of 256 is 29% apart, the rest under 1.4%).
  llama4's top-1 router is held at f32 only: there such a move replaces a
  token's whole FFN output, and under scatter it shifts which later tokens
  overflow the capacity (10% Frobenius measured at bf16).
- greedy tokens at f32: equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.flash_attention.ops as j_fa_ops  # noqa: E402
from repro.configs import base as j_configs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import inputs as j_inputs  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.serving.decode import generate as j_generate  # noqa: E402
from repro.serving.decode import prefill as j_prefill  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base as t_configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import slots_ref  # noqa: E402
from repro_torch.models import build_model, inputs, mamba, module, moe  # noqa: E402
from repro_torch.serving import generate, prefill  # noqa: E402
from repro_torch.training.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

F32_RTOL = 1e-4
BF16_FROB = 0.03
AUX_ATOL = 1e-6

ARCHS = {"granite": ("granite-moe-3b-a800m", 2), "hymba": ("hymba-1.5b", 2),
         "qwen2-vl": ("qwen2-vl-2b", None), "hubert": ("hubert-xlarge", None),
         "llama4": ("llama4-maverick-400b-a17b", None)}
DECODERS = ["granite", "hymba", "qwen2-vl"]


@pytest.fixture(autouse=True)
def interpret_kernels(monkeypatch):
    """The reference's flash attention in interpret mode (the CPU backend
    runs no other), through its own ``ops`` wrapper."""
    monkeypatch.setattr(j_fa_ops, "flash_attention",
                        functools.partial(j_fa_ops.flash_attention,
                                          interpret=True))


def _cfg(name: str, dtype: str = "float32"):
    arch, kv = ARCHS[name]
    cfg = configs.get_config(arch).reduced()
    if kv:
        cfg = cfg.replace(num_kv_heads=kv)
    return cfg.replace(dtype=dtype)


def _jcfg(cfg):
    return j_configs.ModelConfig(**vars(cfg))


@functools.lru_cache(maxsize=None)
def _params(name: str):
    """One JAX init per model (params are f32 at either compute dtype)."""
    jp = j_build_model(_jcfg(_cfg(name))).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _models(name: str, dtype: str):
    """(jax model, jax params, port model, port params)."""
    cfg = _cfg(name, dtype)
    jp, tp = _params(name)
    return j_build_model(_jcfg(cfg)), jp, build_model(cfg, "cpu"), tp


def _inputs(cfg, b=2, s=128, seed=1):
    """The same prefill inputs from both packages' ``materialize``."""
    jin = j_inputs.materialize(j_inputs.prefill_specs(_jcfg(cfg), b, s),
                               _jcfg(cfg), seed=seed)
    tin = inputs.materialize(inputs.prefill_specs(cfg, b, s), cfg,
                             seed=seed, device="cpu")
    return jin, tin


def _tokens(cfg, b=2, s=12, seed=2):
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


FORWARD_CASES = [("granite", "scatter"), ("granite", "dense"),
                 ("hymba", "scatter"), ("qwen2-vl", "scatter"),
                 ("hubert", "scatter")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,dispatch", FORWARD_CASES,
                         ids=[f"{n}-{d}" for n, d in FORWARD_CASES])
def test_forward_full_matches_jax_kernel_path(name, dispatch, dtype):
    jm, jp, tm, tp = _models(name, dtype)
    jin, tin = _inputs(tm.cfg)
    opts = {"impl": "flash", "moe_dispatch": dispatch}
    want, want_aux = jm.forward(jp, jin, opts)
    got, aux = tm.forward(tp, tin, opts)
    V = tm.cfg.vocab_size
    assert got.dtype == module.dtype_of(dtype)
    assert tuple(got.shape) == (2, 128, tm.cfg.vocab_padded)
    _check(got[..., :V], _np(want)[..., :V], dtype)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    if dtype == "float32":
        assert abs(float(aux) - float(want_aux)) <= AUX_ATOL
    if not tm.cfg.num_experts:
        assert float(aux) == 0.0
    logits = make_prefill_step(tm, opts)(tp, tin)
    assert torch.equal(logits, got)


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_top1_moe_forward_matches_jax_at_f32(dispatch):
    """llama4-maverick's code path (128 experts top-1 at full size)."""
    jm, jp, tm, tp = _models("llama4", "float32")
    jin, tin = _inputs(tm.cfg)
    opts = {"moe_dispatch": dispatch}
    want, want_aux = jm.forward(jp, jin, {"impl": "flash", **opts})
    got, aux = tm.forward(tp, tin, opts)
    _check(got, _np(want), "float32")
    assert abs(float(aux) - float(want_aux)) <= AUX_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_decode_step_match_jax(name, dtype):
    """The cache-exact token loop (``prefill``) and one more
    ``decode_step`` against the reference's: logits and carried state
    (hybrid: the kv cache, the conv window and the ssm state)."""
    jm, jp, tm, tp = _models(name, dtype)
    toks = _tokens(tm.cfg)
    ctx = 16
    jl, jst, jpos = j_prefill(jm, jp, jnp.asarray(toks), context_len=ctx)
    tl, tst, tpos = prefill(tm, tp, torch.from_numpy(toks), context_len=ctx)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    _check(tl, _np(jl), dtype)
    j_leaves = jax.tree_util.tree_leaves(jst)
    assert len(tree_leaves(tst)) == len(j_leaves)
    for a, b in zip(tree_leaves(tst), j_leaves):
        assert tuple(a.shape) == b.shape
        _check(a, _np(b), dtype)
    nxt = np.full((2, 1), 7, np.int32)
    jl2, _ = jm.decode(jp, jnp.asarray(nxt), jst, jpos)
    tl2, _ = make_decode_step(tm)(tp, torch.from_numpy(nxt), tst, tpos)
    _check(tl2, _np(jl2), dtype)


@pytest.mark.parametrize("name", DECODERS)
def test_greedy_generate_tokens_equal_jax(name):
    jm, jp, tm, tp = _models(name, "float32")
    toks = _tokens(tm.cfg, s=10, seed=3)
    want = np.asarray(j_generate(jm, jp, jnp.asarray(toks), max_new=8,
                                 context_len=18))
    got = generate(tm, tp, torch.from_numpy(toks), max_new=8, context_len=18)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", DECODERS)
def test_kernel_path_matches_cache_path(name):
    """The full forward's last logits equal the token loop's.  moe under
    ``dense``: the scatter path's capacity depends on the tokens routed
    at once (B·S in the forward, B a step in the loop)."""
    _, _, tm, tp = _models(name, "float32")
    toks = torch.from_numpy(_tokens(tm.cfg, seed=4))
    opts = {"moe_dispatch": "dense"}
    full, _ = tm.forward(tp, {"tokens": toks}, opts)
    last, _, _ = prefill(tm, tp, toks, context_len=12, opts=opts)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# the mamba branch
# ---------------------------------------------------------------------------

def _mamba_case(dtype: str, s: int = 64):
    cfg = _cfg("hymba", dtype)
    jp, tp = _params("hymba")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mamba"])
    tl = {k: v[0] for k, v in tp["layers"]["mamba"].items()}
    x = np.random.default_rng(5).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    dt = module.dtype_of(dtype)
    return cfg, jl, tl, x, torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_full_matches_jax(dtype):
    cfg, jl, tl, x, xt = _mamba_case(dtype)
    want = j_mamba.mamba_full(jl, _jcfg(cfg), jnp.asarray(x, dtype))
    got = mamba.mamba_full(tl, cfg, xt)
    assert got.dtype == xt.dtype
    _check(got, _np(want), dtype)


def test_mamba_decode_chain_matches_full_scan():
    """``mamba_decode`` step by step from ``init_mamba_state`` gives the
    full scan's outputs, and its state the scan's last state."""
    cfg, _, tl, _, xt = _mamba_case("float32", s=40)
    full = mamba.mamba_full(tl, cfg, xt)
    st = mamba.init_mamba_state(cfg, 2, torch.float32)
    steps = []
    for t in range(xt.shape[1]):
        y, st = mamba.mamba_decode(tl, cfg, xt[:, t:t + 1], st)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5 * float(full.abs().max()))
    assert tuple(st["conv"].shape) == (2, cfg.ssm_conv - 1, cfg.d_inner)
    assert tuple(st["ssm"].shape) == (2, cfg.d_inner, cfg.ssm_state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_follows_xla(dtype):
    """``jax.nn.softplus`` op by op: bf16 values equal, beyond the
    threshold (20) of ``torch.nn.functional.softplus`` too.  At -88 the
    value is subnormal, which XLA's CPU flushes to zero and torch keeps:
    the bf16 bound is the least normal f32."""
    x = np.concatenate([np.linspace(-30, 30, 4001, dtype=np.float32),
                        [0.0, -0.0, 88.0, -88.0]]).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _np(jax.jit(jax.nn.softplus)(jnp.asarray(x, jdt)))
    got = mamba.softplus(torch.from_numpy(x).to(module.dtype_of(dtype)))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=float(np.finfo(np.float32).tiny))
        assert np.array_equal(got.float().numpy()[:-1], want[:-1])
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# the router: ties and capacity
# ---------------------------------------------------------------------------

def test_router_ties_follow_lax_top_k():
    """Probabilities from a few levels, so that most rows hold ties: the
    port's top-k equals ``jax.lax.top_k`` in values and order (the lower
    index first among equals), at every k."""
    rng = np.random.default_rng(6)
    probs = (rng.integers(0, 4, (512, 40)) / 8.0).astype(np.float32)
    probs[0] = 0.25                                   # one row all equal
    for k in (1, 2, 8, 40):
        jw, je = jax.lax.top_k(jnp.asarray(probs), k)
        tw, te = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert moe.top_k(torch.from_numpy(probs), 8)[1][0].tolist() == list(
        range(8))


def _overflow_case(name: str, dispatch: str):
    """A zero router: every probability ties, so every token routes to
    the first k experts (expert 0 first) and overflows their capacity."""
    cfg = _cfg(name)
    jp, tp = _params(name)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    jl = {**jl, "router": jnp.zeros_like(jl["router"])}
    tl = {"router": torch.zeros_like(tp["layers"]["moe"]["router"][0]),
          "experts": {k: v[0] for k, v in
                      tp["layers"]["moe"]["experts"].items()}}
    x = np.random.default_rng(7).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    want, want_aux = j_moe.moe_ffn(jl, _jcfg(cfg), jnp.asarray(x),
                                   dispatch=dispatch)
    got, aux = moe.moe_ffn(tl, cfg, torch.from_numpy(x), dispatch=dispatch)
    return cfg, _np(want), float(want_aux), got.numpy(), float(aux)


@pytest.mark.parametrize("name", ["granite", "llama4"])
def test_capacity_overflow_drops_the_reference_tokens(name):
    cfg, want, want_aux, got, aux = _overflow_case(name, "scatter")
    T, k, E = 256, cfg.experts_per_token, cfg.num_experts
    C = moe.capacity(T, cfg)
    assert C == max(8, int(1.25 * T * k / E + 0.5)) and C < T
    _check(torch.from_numpy(got), want, "float32")
    assert abs(aux - want_aux) <= AUX_ATOL
    # every token routes to experts 0..k-1 with weight 1/k: the first C
    # tokens keep their routes, the rest are dropped whole (zero output)
    dropped_ref = np.all(want.reshape(T, -1) == 0.0, axis=1)
    dropped = np.all(got.reshape(T, -1) == 0.0, axis=1)
    np.testing.assert_array_equal(dropped, dropped_ref)
    assert dropped.tolist() == [False] * C + [True] * (T - C)
    slot, keep, _ = slots_ref(torch.arange(k).repeat(T), E, C)
    assert int(keep.sum()) == k * C and int((slot == E * C).sum()) == \
        k * (T - C)
    # the dense path drops nothing: it equals the reference's dense path
    _, want_d, _, got_d, _ = _overflow_case(name, "dense")
    _check(torch.from_numpy(got_d), want_d, "float32")
    assert not np.all(got_d.reshape(T, -1) == 0.0, axis=1).any()


# ---------------------------------------------------------------------------
# inputs, params, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-vl", "hubert", "granite"])
def test_materialize_matches_the_reference(name, dtype):
    cfg = _cfg(name, dtype)
    for kind in ("train", "prefill", "decode"):
        if kind == "decode" and cfg.is_encoder_only:
            with pytest.raises(ValueError, match="encoder-only"):
                inputs.decode_specs(cfg, 2, 8)
            continue
        jspec = j_inputs.input_specs(_jcfg(cfg),
                                     j_configs.InputShape("t", 24, 3, kind))
        tspec = inputs.input_specs(cfg, t_configs.InputShape("t", 24, 3,
                                                             kind))
        assert list(tspec) == list(jspec)
        want = j_inputs.materialize(jspec, _jcfg(cfg), seed=8)
        got = inputs.materialize(tspec, cfg, seed=8, device="cpu")
        for key in jspec:
            assert tuple(got[key].shape) == jspec[key].shape, key
            assert str(got[key].dtype).split(".")[-1] == str(
                jspec[key].dtype), key
            np.testing.assert_array_equal(
                got[key].float().numpy() if got[key].is_floating_point()
                else got[key].numpy(),
                _np(want[key]) if got[key].is_floating_point()
                else np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("name", list(ARCHS))
def test_param_tree_matches_the_reference_layout(name):
    """The port's own init has the reference's keys, shapes and dtypes
    (stacked (L, ...) layers, (L, E, ...) experts, the mamba leaves, no
    embedding table for hubert), and the converted JAX tree keeps them."""
    jm, jp, tm, tp = _models(name, "float32")
    own = tm.init(torch.Generator().manual_seed(0))
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)
    for tree in (own, tp):
        t_leaves = tree_leaves(tree)
        assert len(j_leaves) == len(t_leaves)
        for (path, a), b in zip(j_leaves, t_leaves):
            assert tuple(b.shape) == a.shape, path
            assert str(b.dtype).split(".")[-1] == str(a.dtype), path
    assert sorted(own) == sorted(jp)
    assert ("embed" in own) == (name != "hubert")
    assert module.param_count(own) == sum(a.size for _, a in j_leaves)
    for (path, a), b in zip(j_leaves, tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_forward_full_launches_no_kernel_on_the_cpu():
    fa_kernel.reset_launches()
    for name in ARCHS:
        _, _, tm, tp = _models(name, "float32")
        tm.forward(tp, _inputs(tm.cfg, s=32)[1])
    assert fa_kernel.LAUNCHES == {"flash_attention_bh": 0}


@pytest.mark.parametrize("name", ["granite", "hymba", "qwen2-vl", "hubert"])
def test_serve_launcher_runs_on_the_cpu(name, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--reduced", "--arch",
                       ARCHS[name][0], "--batch", "2", "--prompt-len", "5",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    if name == "hubert":
        assert "encoder-only: no autoregressive serving" in out
    else:
        assert "device=cpu" in out and "generated 8 tokens" in out
