"""The zoo's two kernel twins (flash attention, WKV6) on the CPU against
the JAX package's Pallas kernels in interpret mode.

The same numpy inputs go through the reference's ``ops`` wrappers with
``interpret=True`` and the port's wrappers on CPU tensors, which run the
port's plain twins (``repro_torch/kernels/*/ref.py``).  The CUDA kernels
are held to the same twins on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``).

Tolerances, relative to the largest magnitude of the reference output:
- f32: 1e-5.  The twins sum in another order than the kernels (a dense
  softmax against the online one; einsum against the kernel's row sum);
  measured below 1e-6.
- bf16 outputs: 2**-8, one bf16 rounding at the largest magnitude.  Both
  sides compute in f32 from the same bf16 inputs and round once, so an
  element differs only where the f32 values straddle a rounding boundary.
- WKV6 final state (f32): 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as j_attention_ref)
from repro.kernels.wkv6.ops import wkv6 as j_wkv6  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402

torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 2 ** -8

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a: np.ndarray, dt) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt)


def _close(got: torch.Tensor, want: np.ndarray, rtol: float):
    got = got.float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale, rtol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

MASKS = {"causal": (True, 0), "full": (False, 0),
         # a window smaller than the reference's 128-row tile and than the
         # kernel's 64-row tile: rows wholly masked inside live tiles
         "window16": (True, 16)}


# every group size at D=32, S=128 (one 128-row reference tile); D=64 at
# S=256 (a 2 x 2 grid of reference tiles) at the Llama-3.2-1B ratio G=4;
# D=80 at G=1 (hubert-xlarge's head dim, 16 q and 16 kv heads)
SHAPES = [(1, 32, 128), (2, 32, 128), (4, 32, 128), (4, 64, 256),
          (1, 80, 128)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,d,s", SHAPES,
                         ids=[f"G{g}-D{d}-S{s}" for g, d, s in SHAPES])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_twin_matches_jax_kernel(mask, g, d, s, dtype):
    causal, window = MASKS[mask]
    jdt, tdt = DTYPES[dtype]
    kv = 2
    rng = np.random.default_rng(list(MASKS).index(mask) * 1000 + g * 100 + d)
    q = rng.standard_normal((1, s, kv * g, d)).astype(np.float32)
    k = rng.standard_normal((1, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((1, s, kv, d)).astype(np.float32)
    want = _np(j_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                       causal=causal, window=window, interpret=True))
    got = flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal,
                          window=window)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    _close(got, want, F32_RTOL if dtype == "f32" else BF16_RTOL)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (100, 100, True, 0),        # ragged: not a multiple of any tile
    (77, 77, False, 0),
    (130, 130, True, 20),
    (50, 130, True, 0),         # Sq < Sk, ends aligned
    (1, 130, True, 0),          # one query against a long key range
    (64, 200, True, 48),
])
def test_flash_twin_ragged_and_short_queries(sq, sk, causal, window):
    """The twin takes any S and Sq <= Sk (the reference's kernel asserts
    tile multiples); held to the reference's ``attention_ref``."""
    g, kv, d = 2, 2, 32
    rng = np.random.default_rng(sq * 1000 + sk)
    q = rng.standard_normal((kv * g, sq, d)).astype(np.float32)
    k = rng.standard_normal((kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((kv, sk, d)).astype(np.float32)
    oracle = jax.jit(j_attention_ref, static_argnames=("causal", "window"))
    want = _np(oracle(jnp.asarray(q), jnp.asarray(np.repeat(k, g, 0)),
                      jnp.asarray(np.repeat(v, g, 0)), causal=causal,
                      window=window))
    got = fa_kernel.flash_attention_bh(_t(q, torch.float32),
                                       _t(k, torch.float32),
                                       _t(v, torch.float32), group_size=g,
                                       causal=causal, window=window)
    _close(got, want, F32_RTOL)


def test_flash_wrapper_refuses_bad_shapes_and_dtypes():
    q = torch.zeros(4, 8, 32)
    k = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="group_size"):
        fa_kernel.flash_attention_bh(q, k, k, group_size=1)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa_kernel.flash_attention_bh(q, k[:, :4], k[:, :4], group_size=2)
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_bh(q.double(), k.double(), k.double(),
                                     group_size=2)
    with pytest.raises(TypeError, match="one dtype"):
        fa_kernel.flash_attention_bh(q, k.bfloat16(), k, group_size=2)
    assert fa_kernel.LAUNCHES["flash_attention_bh"] == 0  # twins only here


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (rng.random((b, s, h, d)) * 0.4 + 0.55).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,d", [(2, 128, 2, 32), (1, 128, 2, 64),
                                     (1, 64, 1, 128)],
                         ids=["D32", "D64", "D128"])
def test_wkv6_twin_matches_jax_kernel_and_ref(b, s, h, d, dtype):
    """r, k, v in the compute dtype and w in f32, as the model feeds them
    (``_decay`` returns f32)."""
    jdt, tdt = DTYPES[dtype]
    r, k, v, w, u = _wkv_inputs(b, s, h, d, seed=d + s)
    jr, jk, jv = (jnp.asarray(a, jdt) for a in (r, k, v))
    jw, ju = jnp.asarray(w), jnp.asarray(u)
    y_k, s_k = j_wkv6(jr, jk, jv, jw, ju, chunk=64, interpret=True)
    y_r, s_r = j_wkv6_ref(jr, jk, jv, jw, ju,
                          jnp.zeros((b, h, d, d), jnp.float32))
    y, sf = wkv6(_t(r, tdt), _t(k, tdt), _t(v, tdt), _t(w, torch.float32),
                 _t(u, torch.float32))
    assert y.dtype == tdt and sf.dtype == torch.float32
    rtol = F32_RTOL if dtype == "f32" else BF16_RTOL
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        _close(y, _np(want_y), rtol)
        _close(sf, _np(want_s), F32_RTOL)


def test_wkv6_refuses_an_initial_state_and_other_dtypes():
    """The reference's wrapper takes S0 and ignores it; the port raises."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(1, 8, 2, 32, 0))
    with pytest.raises(ValueError, match="S0"):
        wkv6(r, k, v, w, u, torch.zeros(1, 2, 32, 32))
    with pytest.raises(TypeError, match="float32"):
        wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError, match="one dtype"):
        wkv6(r.bfloat16(), k, v, w, u)
    with pytest.raises(TypeError):
        wkv6(r.double(), k.double(), v.double(), w, u)
    y, _ = wkv6(r, k, v, w, u)
    assert y.shape == r.shape
    assert wkv_kernel.LAUNCHES["wkv6_bh"] == 0


def test_wkv6_twin_is_the_prefix_sum_with_unit_decay():
    """With w == 1 and u == 0, y_t = r_t . sum_{s<t} k_s v_s^T (the
    reference's own property test), on a ragged length."""
    r, k, v, _, _ = (torch.from_numpy(a) for a in _wkv_inputs(1, 37, 1, 32,
                                                               3))
    y, sf = wkv6(r, k, v, torch.ones_like(r), torch.zeros(1, 32))
    kv = torch.einsum("bshi,bshj->bshij", k.double(), v.double())
    prefix = torch.cumsum(kv, dim=1) - kv
    want = torch.einsum("bshi,bshij->bshj", r.double(), prefix)
    assert float((y.double() - want).abs().max()) < 1e-5
    assert float((sf.double() - kv.sum(1)).abs().max()) < 1e-5
