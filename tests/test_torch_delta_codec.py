"""The port's delta codec on the CPU against the JAX package.

Kernel level: the twins of ``quantize_blocks``/``dequantize_blocks`` (what
the wrappers run on CPU tensors) against the Pallas kernels in interpret
mode and against ``ref.py`` under ``jax.jit``: q, scales and the dequantized
values must be **bitwise equal**.  Under jit XLA turns the reference's
``absmax / qmax`` into a multiply by the f32 reciprocal of qmax, and so
does the port; the eager ``quantize_ref`` really divides, so against it the
scales agree within one ulp and q wherever the scales are equal.  The
inputs hold all-zero rows and rows whose lanes land exactly on k + 0.5
quanta, where rounding half to even shows.

Ops level: ``encode_delta`` on the paper CNN (q and scales bitwise) and
``decode_delta`` (within one ulp of the largest of base, delta and sum:
the jitted reference may fuse base + q·scale into an FMA),
the ``stacked_flatten`` layout (equal), ``payload_bytes``/``codec_ratio``
and the derived ``compress_ratio`` (equal).

Slice level: the fused codec round (``use_delta_codec=True``) against the
JAX fused engine for opt, deadline and opt_trimmed at bits 8 and 4: the
per-round counts and bytes must be equal, params within 1e-4 plus one
quantization step (the largest scale the round's codec produced), since a
1e-7 difference in a delta may move one lane across a .5 boundary.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.hsfl import HSFLConfig as JConfig  # noqa: E402
from repro.core.hsfl import HSFLSimulation as JSim  # noqa: E402
from repro.core.hsfl import model_compress_ratio as j_ratio  # noqa: E402
from repro.kernels.delta_codec import kernel as jk  # noqa: E402
from repro.kernels.delta_codec import ops as jops  # noqa: E402
from repro.kernels.delta_codec import ref as jref  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import fused_round  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation  # noqa: E402
from repro_torch.core.hsfl import model_compress_ratio  # noqa: E402
from repro_torch.kernels.delta_codec import kernel as tk  # noqa: E402
from repro_torch.kernels.delta_codec import ops as tops  # noqa: E402

torch.set_num_threads(1)


def codec_input(m: int, block: int, bits: int, seed: int):
    """Gaussian rows, all-zero rows, and tie rows: scale 2^-e (absmax
    qmax·2^-e in lane 0) with every other lane at (k + 0.5)·2^-e.
    Returns x and the indices of the zero rows and of the tie rows."""
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    x = (rng.standard_normal((m, block)) * 1e-3).astype(np.float32)
    ties = np.arange(3, m, 11)
    zeros = np.setdiff1d(np.arange(0, m, 7), ties)
    x[zeros] = 0.0
    for r in ties:
        s = np.float32(2.0 ** -(8 + r % 5))
        k = rng.integers(-qmax, qmax, size=block - 1).astype(np.float32)
        x[r, 0] = qmax * s
        x[r, 1:] = (k + np.float32(0.5)) * s
    return x, zeros, ties


KERNEL_CASES = [(bits, block, m) for bits in (4, 8) for block in (128, 512)
                for m in (217, 512)]


@pytest.mark.parametrize("bits,block,m", KERNEL_CASES,
                         ids=[f"int{b}-block{k}-M{m}"
                              for b, k, m in KERNEL_CASES])
def test_twins_equal_pallas_kernels_bitwise(bits, block, m):
    x, zeros, ties = codec_input(m, block, bits, seed=bits * 1000 + block + m)
    q, s = tk.quantize_blocks(torch.from_numpy(x), bits=bits)
    q, s = q.numpy(), s.numpy()
    qp, sp = jk.quantize_blocks(jax.numpy.asarray(x), interpret=True,
                                bits=bits)
    qj, sj = jax.jit(jref.quantize_ref, static_argnums=1)(x, bits)
    for want_q, want_s in ((qp, sp), (qj, sj)):
        np.testing.assert_array_equal(q, np.asarray(want_q))
        np.testing.assert_array_equal(s, np.asarray(want_s))
    # the eager oracle divides by qmax: one ulp on some scales at most
    qe, se = (np.asarray(a) for a in jref.quantize_ref(x, bits))
    np.testing.assert_array_max_ulp(s, se, maxulp=1)
    same = (s == se)[:, 0]
    np.testing.assert_array_equal(q[same], qe[same])

    # zero rows: scale 1e-12 and q = 0
    assert np.all(s[zeros] == np.float32(1e-12)) and not q[zeros].any()
    # tie rows land on k + 0.5 exactly and round half to even
    quot = x[ties, 1:] / s[ties]
    assert np.all(quot - np.floor(quot) == 0.5)
    assert np.all(q[ties, 1:] % 2 == 0)
    away = np.trunc(quot + np.sign(quot) * 0.5)
    assert np.any(q[ties, 1:] != away), "no tie rounded differently"

    xd = tk.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s))
    xp = jk.dequantize_blocks(qp, sp, interpret=True)
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xp))
    np.testing.assert_array_equal(
        xd.numpy(), np.asarray(jax.jit(jref.dequantize_ref)(qj, sj)))


def test_wrappers_validate_like_the_reference():
    x = torch.zeros((4, 100))
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.quantize_blocks(x)
    with pytest.raises(ValueError, match="bit depth"):
        tk.quantize_blocks(torch.zeros((4, 128)), bits=2)
    assert (tk.BLOCK, tk.TILE_ROWS, tk.BITS) == (jk.BLOCK, jk.TILE_ROWS,
                                                 jk.BITS)
    tk.reset_launches()
    tk.quantize_blocks(torch.zeros((4, 128)))
    assert tk.LAUNCHES == {"quantize_blocks": 0, "dequantize_blocks": 0}


# ---------------------------------------------------------------------------
# ops level
# ---------------------------------------------------------------------------

def _paper_params(seed: int):
    """Two paper-CNN trees as numpy: a base and a perturbed update."""
    base = jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    upd = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * 1e-2).astype(
            np.float32), base)
    return base, upd


@pytest.mark.parametrize("bits,block", [(8, 512), (4, 512), (8, 128)])
def test_encode_decode_equal_jax_on_paper_cnn(bits, block):
    base, upd = _paper_params(1)
    jp = jops.encode_delta(upd, base, interpret=True, block=block, bits=bits)
    tb, tu = params_from_numpy(base, "cpu"), params_from_numpy(upd, "cpu")
    tp = tops.encode_delta(tu, tb, block=block, bits=bits)
    np.testing.assert_array_equal(tp["q"].numpy(), np.asarray(jp["q"]))
    np.testing.assert_array_equal(tp["scales"].numpy(),
                                  np.asarray(jp["scales"]))
    # 217 rows of 512; 865 rows of 128 pad to 1024 (past one tile)
    assert tuple(tp["q"].shape) == tuple(jp["q"].shape) == (
        {512: 217, 128: 1024}[block], block)
    assert (tp["n"], tp["bits"]) == (int(jp["n"]), int(jp["bits"])) \
        == (110634, bits)
    assert tops.payload_bytes(tp) == jops.payload_bytes(jp)
    # decode: base + q·scale; the jitted reference may contract the
    # multiply and the add into one FMA: one ulp of the largest term
    want = jops.decode_delta(jp, base, interpret=True)
    got = params_to_numpy(tops.decode_delta(tp, tb))
    for layer in want:
        for leaf in want[layer]:
            b, g = base[layer][leaf], got[layer][leaf]
            ulp = np.spacing(np.maximum(np.maximum(np.abs(b), np.abs(g)),
                                        np.abs(g - b)))
            assert np.all(np.abs(g - np.asarray(want[layer][leaf])) <= ulp)


def test_stacked_flatten_layout_equals_jax():
    trees = [_paper_params(s)[1] for s in range(3)]
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)
    jflat, jn = jops.stacked_flatten(stacked, block=512)
    tstacked = params_from_numpy(stacked, "cpu")
    tflat, tn = tops.stacked_flatten(tstacked, block=512)
    assert tn == jn == 110634 and tuple(tflat.shape) == (3, 256, 512)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = params_to_numpy(tops.stacked_unflatten(tflat, tstacked))
    for layer in stacked:
        for leaf in stacked[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          stacked[layer][leaf])
    # one tree past a tile pads to a multiple of TILE_ROWS, else not
    assert [tops._padded_rows(n) for n in (110634, 512 * 300)] == \
        [jops._padded_rows(n) for n in (110634, 512 * 300)] == [217, 512]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [128, 512, 1024])
def test_ratios_equal_jax(bits, block):
    assert tops.codec_ratio(110634, block, bits) == \
        jops.codec_ratio(110634, block, bits)
    kw = dict(use_delta_codec=True, codec_block=block, codec_bits=bits)
    assert model_compress_ratio(HSFLConfig(**kw)) == j_ratio(JConfig(**kw))
    assert tops.COMPRESS_RATIO == jops.COMPRESS_RATIO


def test_paper_cnn_ratio():
    """110 634 parameters: 217 blocks of 512 -> 0.2530 of f32 at int8."""
    r = model_compress_ratio(HSFLConfig(use_delta_codec=True))
    assert r == (217 * 512 + 217 * 4) / (4.0 * 110634)
    assert abs(r - 0.2530) < 1e-4
    assert model_compress_ratio(HSFLConfig(compress_ratio=0.5)) == 0.5


# ---------------------------------------------------------------------------
# slice level: the fused codec round
# ---------------------------------------------------------------------------

def _cfg(cls, scheme, bits):
    # tests/test_torch_hsfl.py's small config; seed 4 rescues a snapshot in
    # round 2
    return cls(rounds=2, n_uavs=8, k_select=4, n_train=400, n_test=100,
               steps_per_epoch=2, local_epochs=3, scheme=scheme, seed=4, b=2,
               use_delta_codec=True, codec_bits=bits)


ROUND_CASES = [(s, b) for s in ("opt", "deadline", "opt_trimmed")
               for b in (8, 4)]


@pytest.mark.parametrize("scheme,bits", ROUND_CASES,
                         ids=[f"{s}-int{b}" for s, b in ROUND_CASES])
def test_fused_codec_round_matches_jax(monkeypatch, scheme, bits):
    scales = []
    quantize = fused_round.quantize_blocks

    def spy(x, bits=8):
        q, s = quantize(x, bits=bits)
        scales.append(float(s.max()))
        return q, s

    monkeypatch.setattr(fused_round, "quantize_blocks", spy)
    jsim = JSim(_cfg(JConfig, scheme, bits))
    tsim = HSFLSimulation(_cfg(HSFLConfig, scheme, bits), device="cpu")
    assert tsim.compress_ratio == jsim.compress_ratio
    tsim.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsim.params), "cpu")
    jd, td, rows = [], [], []
    for t in (1, 2):
        jl, jd = jsim.run_round(t, jd)
        tl, td = tsim.run_round(t, td)
        rows.append(((jl.selected, jl.arrived_final, jl.used_snapshot,
                      jl.delayed, jl.dropped, jl.bytes_sent),
                     (tl.selected, tl.arrived_final, tl.used_snapshot,
                      tl.delayed, tl.dropped, tl.bytes_sent)))
    for want, got in rows:
        assert got == want
    assert sum(r[1][2] for r in rows) > 0, "fixture no longer rescues"
    assert len(scales) == 2          # one quantize per probe epoch
    tol = 1e-4 + max(scales)
    jp = jax.tree_util.tree_map(np.asarray, jsim.params)
    tp = params_to_numpy(tsim.params)
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_allclose(tp[layer][leaf], jp[layer][leaf],
                                       rtol=0, atol=tol,
                                       err_msg=f"{layer}.{leaf}")
