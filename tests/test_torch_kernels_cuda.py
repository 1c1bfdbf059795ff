"""The CUDA kernels (fused CNN, delta codec, flash attention, WKV6, moe
dispatch) against their plain twins on the card, and the port's import
hygiene.

The kernel tests need an NVIDIA card (marker ``cuda``): they skip, with a
reason, where ``torch.cuda.is_available()`` is False; on the card run them
with ``PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py``.
The single-user kernels are held to their twins and bitwise to the
blocked kernels at K=1, and the bf16 instantiations to the bf16 twins
(exact for the conv forward, two bf16 ulps of the largest magnitude
elsewhere).
They use the shapes ``chip_smoke.py`` checks: the main path's cohort (K=10,
B=10, both conv layers), an odd cohort (K=3, B=7), the eval shape (K=1,
B=1000) and an all-ones pool-tie cohort.  The conv forward sums in the
twin's order, so its outputs and masks must be equal; everything else
agrees to 1e-5 of the largest magnitude (summation order only).  The
codec kernels are held to their twins bitwise (q, scales and the
dequantized values) at the fused round's M = 256·10 rows and one tree's
217, blocks 128 and 512, int8 and int4, with all-zero rows and lanes on
exact .5 quanta.

The moe dispatch kernels (slots, scatter, combine) are held to the plain
scatter path at granite-prefill-chat's batch (T 18432, top-8 of 40
experts, d 1536, routes skewed so that some drop) and at a small ragged
shape at k = 1: slots, keep and the expert buffer bit for bit, the
combine bit for bit to its twin and to the plain path within the f32
sums' reordering; a layer on plain tensors launches each wrapper once and
one that autograd records none.

The zoo's kernels are held to their twins at Llama-3.2-1B's and
RWKV6-7B's prefill shapes, on masks, ragged lengths, Sq < Sk and every
head size, and flash attention at the moe, hybrid and vlm families'
group sizes (3, 5 with an odd B·H, and 6), within 1e-5 of the largest
magnitude at f32 and one bf16 ulp (2**-7) at bf16; a reduced prefill must
launch one kernel per layer, and the card's forward must match the CPU
twins (logits, and greedy tokens at f32) for every family.  The flash kernels, WKV6 and the fc forward and backward give the
same bits on every run; WKV6 runs at every head dim it is built for and
flash attention past 65 535 rows of B·H.

Training on the card goes through the einsum paths: the zoo's kernels
refuse CUDA tensors that require a gradient, a reduced train step
launches neither and matches the CPU (loss 1e-5 relative, params 1e-4 of
the largest magnitude).

The hygiene tests run everywhere: the port imports neither JAX, nor the
JAX package, nor ``msgpack`` (absent on the card's machine), and an entry
point given no device refuses to run without a card.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cohort(k, bs, seed, device, ones=False):
    from repro_torch.data.synthetic import make_digits
    from repro_torch.models.cnn import init_cnn
    from repro_torch.utils.tree import tree_map
    params = tree_map(lambda *ls: torch.stack(ls).to(device),
                      *[init_cnn(seed + i, "cpu") for i in range(k)])
    if ones:
        x = torch.ones((k, bs, 28, 28, 1))
    else:
        x = torch.from_numpy(make_digits(k * bs, seed=seed).x).reshape(
            k, bs, 28, 28, 1)
    return params, x.to(device)


def _close(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, (err, scale)


# the main path's cohort, an odd one, an all-ones tie cohort, and a sweep
# group's folded cohort (Fig. 3(c): 6 configs x 10 users)
COHORTS = [(10, 10, False), (3, 7, False), (3, 2, True), (60, 10, False)]
IDS = ["main-K10-B10", "odd-K3-B7", "ones-tie-K3-B2", "sweep-K60-B10"]


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs,ones", COHORTS, ids=IDS)
def test_conv_pool_kernels_match_twins(cuda, k, bs, ones):
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x = _cohort(k, bs, 0, cuda, ones)
    inp = x
    for layer in ("conv1", "conv2"):
        w, b = params[layer]["w"], params[layer]["b"]
        ak, rk = knl.conv_pool_fwd_k(inp, w, b)
        ap, rp = ref.conv_pool_fwd_k(inp, w, b)
        torch.testing.assert_close(ak, ap, rtol=0, atol=0)
        for got, want in zip(rk, rp):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        da = torch.randn(ap.shape, device=cuda) * 0.01
        for need_dx in (False, True):
            for got, want in zip(knl.conv_pool_bwd_k(rp, w, da, need_dx),
                                 ref.conv_pool_bwd_k(rp, w, da, need_dx)):
                if want is None:
                    assert got is None
                else:
                    _close(got, want)
        inp = ap


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs,ones", COHORTS, ids=IDS)
def test_fc_chain_kernels_match_twins(cuda, k, bs, ones):
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, _ = _cohort(k, bs, 1, cuda, ones)
    flat = torch.relu(torch.randn((k, bs, 784), device=cuda))
    lk, rk = knl.fc_chain_fwd_k(flat, params)
    lp, rp = ref.fc_chain_fwd_k(flat, params)
    for got, want in zip((lk, *rk), (lp, *rp)):
        _close(got, want)
    g = torch.randn((k, bs, 10), device=cuda) * 0.1
    gk, dk = knl.fc_chain_bwd_k(flat, rp, params, g)
    gp, dp = ref.fc_chain_bwd_k(flat, rp, params, g)
    _close(dk, dp)
    for layer in gp:
        for leaf in gp[layer]:
            _close(gk[layer][leaf], gp[layer][leaf])


@pytest.mark.cuda
def test_training_step_through_kernels_matches_twins(cuda):
    """A whole step's forward and backward through the kernels against the
    twins' composition, with the image gradient."""
    from repro_torch.kernels.fused_cnn import ops, ref
    params, x = _cohort(10, 10, 3, cuda)
    g = torch.randn((10, 10, 10), device=cuda) * 0.1
    lk, rk = ops.forward_fwd_k(params, x)
    lp, rp = ref.forward_fwd_ref_k(params, x)
    _close(lk, lp)
    gk, dxk = ops.backward_k(params, rp, g, need_dx=True)
    gp, dxp = ref.backward_ref_k(params, rp, g, need_dx=True)
    _close(dxk, dxp)
    for layer in gp:
        for leaf in gp[layer]:
            _close(gk[layer][leaf], gp[layer][leaf])


@pytest.mark.cuda
def test_eval_shape_and_launch_counts(cuda):
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x = _cohort(1, 1000, 2, cuda)
    knl.reset_launches()
    a1k, none = knl.conv_pool_fwd_k(x, params["conv1"]["w"],
                                    params["conv1"]["b"], residuals=False)
    assert none is None
    a1p, _ = ref.conv_pool_fwd_k(x, params["conv1"]["w"],
                                 params["conv1"]["b"], residuals=False)
    torch.testing.assert_close(a1k, a1p, rtol=0, atol=0)
    lk, _ = knl.fc_chain_fwd_k(torch.relu(torch.randn((1, 1000, 784),
                                                      device=cuda)), params)
    assert knl.LAUNCHES["conv_pool_fwd_k"] == 1
    assert knl.LAUNCHES["fc_chain_fwd_k"] == 1
    # a CUDA tensor never takes the twin: a wrong dtype raises
    with pytest.raises(TypeError, match="float32"):
        knl.conv_pool_fwd_k(x.double(), params["conv1"]["w"],
                            params["conv1"]["b"])


@pytest.mark.cuda
def test_round_on_card_matches_cpu(cuda):
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    from repro_torch.models.cnn import init_cnn
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = HSFLConfig(rounds=1, n_uavs=8, k_select=4, n_train=400,
                     n_test=100, steps_per_epoch=2, local_epochs=3, seed=4)
    p0 = init_cnn(0, "cpu")
    out = []
    for dev in (cuda, "cpu"):
        sim = HSFLSimulation(cfg, device=dev)
        sim.params = tree_map(lambda t: t.to(sim.device).clone(), p0)
        log, _ = sim.run_round(1, [])
        out.append(((log.arrived_final, log.used_snapshot, log.dropped,
                     log.bytes_sent), [t.cpu() for t in
                                       tree_leaves(sim.params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).abs().max()) < 1e-4


BF16_RTOL = 2 ** -6     # two bf16 ulps of the largest magnitude


def _cast(tree, dtype):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(dtype), tree)


def _user(params, k=0):
    return {n: {leaf: t[k].contiguous() for leaf, t in params[n].items()}
            for n in params}


def _within(got, want, rtol):
    scale = max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ones", [False, True], ids=["digits", "ones-tie"])
def test_single_user_kernels_match_twins_and_blocked(cuda, dtype, ones):
    """The four single-user kernels on one user (B=10) against their twins,
    and bitwise against the blocked kernels at K=1 (the same contraction
    and the same summation order); the conv forward equals its twin
    exactly at both dtypes.  Launch counts: one per call (the conv
    backward too, since it became one launch)."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    rtol = RTOL if dtype == "f32" else BF16_RTOL
    params, x = _cohort(1, 10, 4, cuda, ones)
    params, x = _cast(params, dt), x.to(dt)
    p = _user(params)
    knl.reset_launches()
    inp, inp_k = x[0], x
    for layer in ("conv1", "conv2"):
        w, b = p[layer]["w"], p[layer]["b"]
        a1, r1 = knl.conv_pool_fwd(inp, w, b)
        ap, rp = ref.conv_pool_fwd(inp, w, b)
        ab, rb = knl.conv_pool_fwd_k(inp_k, params[layer]["w"],
                                     params[layer]["b"])
        for got, want, blocked in zip((a1, *r1), (ap, *rp), (ab, *rb)):
            assert got.dtype == dt
            assert torch.equal(got, want) and torch.equal(got, blocked[0])
        da = (torch.randn(ap.shape, device=cuda) * 0.01).to(dt)
        for need_dx in (False, True):
            got = knl.conv_pool_bwd(rp, w, da, need_dx)
            want = ref.conv_pool_bwd(rp, w, da, need_dx)
            blocked = knl.conv_pool_bwd_k(tuple(r.unsqueeze(0) for r in rp),
                                          params[layer]["w"],
                                          da.unsqueeze(0), need_dx)
            for g, wv, bk, nm in zip(got, want, blocked, ("dw", "db", "dx")):
                if wv is None:
                    assert g is None and bk is None
                    continue
                assert g.dtype == (dt if nm == "dx" else torch.float32)
                assert torch.equal(g, bk[0]), nm
                _within(g, wv, RTOL if nm != "dx" else rtol)
        inp, inp_k = ap, ap.unsqueeze(0)
    flat = inp.reshape(10, -1).contiguous()
    lk, rk = knl.fc_chain_fwd(flat, p)
    lp, rp = ref.fc_chain_fwd(flat, p)
    lb, rb = knl.fc_chain_fwd_k(flat.unsqueeze(0), params)
    for got, want, blocked in zip((lk, *rk), (lp, *rp), (lb, *rb)):
        assert torch.equal(got, blocked[0])
        _within(got, want, rtol)
    g = (torch.randn((10, 10), device=cuda) * 0.1).to(dt)
    gk, dk = knl.fc_chain_bwd(flat, rp, p, g)
    gp, dp = ref.fc_chain_bwd(flat, rp, p, g)
    gb, db = knl.fc_chain_bwd_k(flat.unsqueeze(0),
                                tuple(r.unsqueeze(0) for r in rp), params,
                                g.unsqueeze(0))
    assert torch.equal(dk, db[0])
    _within(dk, dp, rtol)
    for layer in gp:
        for leaf in gp[layer]:
            assert gk[layer][leaf].dtype == torch.float32
            assert torch.equal(gk[layer][leaf], gb[layer][leaf][0])
            _within(gk[layer][leaf], gp[layer][leaf], rtol)
    assert {n: knl.LAUNCHES[n] for n in ("conv_pool_fwd", "conv_pool_bwd",
                                         "fc_chain_fwd", "fc_chain_bwd")} \
        == {"conv_pool_fwd": 2, "conv_pool_bwd": 4, "fc_chain_fwd": 1,
            "fc_chain_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs,ones", COHORTS, ids=IDS)
def test_bf16_blocked_kernels_match_twins(cuda, k, bs, ones):
    """The blocked kernels' bf16 instantiations against the twins at bf16:
    the conv forward (tap-order sum, one rounding) exactly; everything
    else within two bf16 ulps of the largest magnitude (bf16 outputs) or
    to summation order (f32 grads from the same inputs)."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    bf = torch.bfloat16
    params, x = _cohort(k, bs, 5, cuda, ones)
    params, x = _cast(params, bf), x.to(bf)
    inp = x
    for layer in ("conv1", "conv2"):
        w, b = params[layer]["w"], params[layer]["b"]
        ak, rk = knl.conv_pool_fwd_k(inp, w, b)
        ap, rp = ref.conv_pool_fwd_k(inp, w, b)
        for got, want in zip((ak, *rk), (ap, *rp)):
            assert got.dtype == bf and torch.equal(got, want)
        da = (torch.randn(ap.shape, device=cuda) * 0.01).to(bf)
        got = knl.conv_pool_bwd_k(rp, w, da, True)
        want = ref.conv_pool_bwd_k(rp, w, da, True)
        _within(got[0], want[0], RTOL)
        _within(got[1], want[1], RTOL)
        _within(got[2], want[2], BF16_RTOL)
        inp = ap
    flat = inp.reshape(k, bs, -1).contiguous()
    lk, rk = knl.fc_chain_fwd_k(flat, params)
    lp, rp = ref.fc_chain_fwd_k(flat, params)
    for got, want in zip((lk, *rk), (lp, *rp)):
        _within(got, want, BF16_RTOL)
    g = (torch.randn((k, bs, 10), device=cuda) * 0.1).to(bf)
    gk, dk = knl.fc_chain_bwd_k(flat, rp, params, g)
    gp, dp = ref.fc_chain_bwd_k(flat, rp, params, g)
    _within(dk, dp, BF16_RTOL)
    for layer in gp:
        for leaf in gp[layer]:
            assert gk[layer][leaf].dtype == torch.float32
            _within(gk[layer][leaf], gp[layer][leaf], BF16_RTOL)
    with pytest.raises(TypeError, match="bfloat16"):
        knl.conv_pool_fwd_k(x, params["conv1"]["w"].float(),
                            params["conv1"]["b"])


CONV_SHAPES = [
    # (K, B, H, C, O, residuals): the round's cohort at both layers, the
    # eval (K=1, B=1000, forward without residuals), a ragged image (B=3,
    # 6 x 6) and a (C, O) outside the paper's, which runs the kernels'
    # runtime-shape instantiation
    (10, 10, 28, 1, 8, True), (10, 10, 14, 8, 16, True),
    (1, 1000, 28, 1, 8, False), (1, 1000, 14, 8, 16, False),
    (2, 3, 6, 1, 8, True), (2, 3, 6, 3, 5, True),
    # a sweep group's eval: G = 6 models, each on the 1000 test images
    (6, 1000, 28, 1, 8, False), (6, 1000, 14, 8, 16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,bs,h,c,o,res", CONV_SHAPES,
                         ids=[f"K{s[0]}-B{s[1]}-H{s[2]}-C{s[3]}-O{s[4]}"
                              f"{'' if s[5] else '-eval'}"
                              for s in CONV_SHAPES])
def test_conv_pair_matches_twins_and_repeats(cuda, k, bs, h, c, o, res,
                                             dtype):
    """The conv forward and backward against their twins at the round's,
    the eval's, a ragged and a runtime (C, O) shape: the forward's outputs
    and masks equal, dW and db to summation order, dx within two bf16 ulps
    at bf16; the same bits on a second run, one launch a call."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(cuda).manual_seed(k * 1000 + h * 10 + c)
    x = torch.relu(torch.randn((k, bs, h, h, c), device=cuda, generator=g))
    x[:, :, : h // 3] = 0      # a zero background: tied pool maxima
    w = torch.randn((k, 3, 3, c, o), device=cuda, generator=g) * 0.3
    b = torch.randn((k, o), device=cuda, generator=g) * 0.1
    x, w, b = x.to(dt), w.to(dt), b.to(dt)
    knl.reset_launches()
    ak, rk = knl.conv_pool_fwd_k(x, w, b, residuals=res)
    ak2, rk2 = knl.conv_pool_fwd_k(x, w, b, residuals=res)
    ap, rp = ref.conv_pool_fwd_k(x, w, b, residuals=res)
    assert torch.equal(ak, ap) and torch.equal(ak, ak2)
    assert knl.LAUNCHES["conv_pool_fwd_k"] == 2
    if not res:
        assert rk is None
        return
    for got, again, want in zip(rk, rk2, rp):
        assert torch.equal(got, want) and torch.equal(got, again)
    da = (torch.randn(ap.shape, device=cuda, generator=g) * 0.01).to(dt)
    for need_dx in (False, True):
        got = knl.conv_pool_bwd_k(rp, w, da, need_dx)
        again = knl.conv_pool_bwd_k(rp, w, da, need_dx)
        want = ref.conv_pool_bwd_k(rp, w, da, need_dx)
        for gt, ag, wv, nm in zip(got, again, want, ("dw", "db", "dx")):
            if wv is None:
                assert gt is None and ag is None
                continue
            assert gt.dtype == (dt if nm == "dx" else torch.float32)
            assert torch.equal(gt, ag), nm
            _within(gt, wv, BF16_RTOL if nm == "dx" and dtype == "bf16"
                    else RTOL)
    assert knl.LAUNCHES["conv_pool_bwd_k"] == 4


# (K, B, H, C, O, residuals) whose bands of pooled rows, as the SM count
# alone picks them, pass the shared memory a block may take: the launcher
# narrows them (whole images of 56 x 56 at the eval's B; 28 x 28 with
# residuals and 8 -> 16 channels)
CONV_NARROWED = [(1, 600, 56, 8, 16, False), (1, 600, 28, 8, 16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs,h,c,o,res", CONV_NARROWED,
                         ids=[f"K{s[0]}-B{s[1]}-H{s[2]}-C{s[3]}-O{s[4]}"
                              f"{'' if s[5] else '-eval'}"
                              for s in CONV_NARROWED])
def test_conv_forward_narrows_its_bands_to_fit(cuda, k, bs, h, c, o, res):
    """Shapes whose first choice of band overflows shared memory run on
    narrower bands and equal the twin (the forward sums in its order)."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    g = torch.Generator(cuda).manual_seed(h * c + o)
    x = torch.relu(torch.randn((k, bs, h, h, c), device=cuda, generator=g))
    w = torch.randn((k, 3, 3, c, o), device=cuda, generator=g) * 0.3
    b = torch.randn((k, o), device=cuda, generator=g) * 0.1
    assert knl.conv_fwd_smem(h // 2, h, c, o, 4, res) > knl.CONV_SMEM_LIMIT
    ak, rk = knl.conv_pool_fwd_k(x, w, b, residuals=res)
    ap, rp = ref.conv_pool_fwd_k(x, w, b, residuals=res)
    assert torch.equal(ak, ap)
    for got, want in zip(rk or (), rp or ()):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("wd,c,o", [(224, 64, 64), (64, 64, 32),
                                    (160, 32, 32)],
                         ids=["W224-C64-O64", "W64-C64-O32", "W160-C32-O32"])
def test_conv_pair_sized_to_shared_memory(cuda, wd, c, o):
    """One image (K=1, B=1) of W x W x C -> O: each call either matches
    the twin, computed on a CPU copy, or is refused before any launch
    with a message that names the shared-memory limit (the sizing rule of
    ``kernel.py`` decides which).  At 224 x 224, 64 -> 64 the forward
    (both modes) and the backward with dx are refused and the backward
    without dx runs on chunks of 8 rows; at 64 x 64, 64 -> 32 and 160 x
    160, 32 -> 32 the backward with dx runs on chunks narrowed to 4
    rows."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    g = torch.Generator().manual_seed(wd + c + o)
    x = torch.relu(torch.randn((1, 1, wd, wd, c), generator=g))
    w = torch.randn((1, 3, 3, c, o), generator=g) * 0.1
    b = torch.randn((1, o), generator=g) * 0.1
    ap, rp = ref.conv_pool_fwd_k(x, w, b)
    da = torch.randn(ap.shape, generator=g) * 0.01
    on = lambda t: t.to(cuda)
    launches = dict(knl.LAUNCHES)
    for res in (True, False):
        fits = knl.conv_fwd_smem(1, wd, c, o, 4, res) <= knl.CONV_SMEM_LIMIT
        if fits:
            ak, rk = knl.conv_pool_fwd_k(on(x), on(w), on(b), residuals=res)
            assert torch.equal(ak.cpu(), ap)
            for got, want in zip(rk or (), rp if res else ()):
                assert torch.equal(got.cpu(), want)
        else:
            with pytest.raises(ValueError, match="232320 bytes"):
                knl.conv_pool_fwd_k(on(x), on(w), on(b), residuals=res)
    for need_dx in (False, True):
        try:
            knl._rows_per_chunk(c, o, wd, 4, need_dx)
        except ValueError:
            with pytest.raises(ValueError, match="shared memory"):
                knl.conv_pool_bwd_k(tuple(map(on, rp)), on(w), on(da),
                                    need_dx)
            continue
        got = knl.conv_pool_bwd_k(tuple(map(on, rp)), on(w), on(da), need_dx)
        want = ref.conv_pool_bwd_k(rp, w, da, need_dx)
        for gt, wv in zip(got, want):
            if wv is None:
                assert gt is None
            else:
                _close(gt.cpu(), wv)
    torch.cuda.synchronize()
    ran = {n: knl.LAUNCHES[n] - launches[n] for n in launches}
    if (wd, c, o) == (224, 64, 64):
        assert ran["conv_pool_fwd_k"] == 0 and ran["conv_pool_bwd_k"] == 1
    else:
        assert ran["conv_pool_bwd_k"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"precision": "bf16"}, {"batch_users": False},
    {"precision": "bf16", "batch_users": False},
    {"kernel": "im2col", "precision": "bf16"}],
    ids=["bf16", "single-f32", "single-bf16", "im2col-bf16"])
def test_policy_round_on_card_matches_cpu(cuda, kw):
    """One fused round under each new policy on the card and on the CPU
    from the same params: equal counts; params within 1e-4 at f32, and at
    bf16 within 2% relative Frobenius per leaf (a one-ulp bf16 difference
    from the f32 summation order moves later roundings).  The kernel
    policies launch the kernels they name."""
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    from repro_torch.kernels.fused_cnn import kernel as knl
    from repro_torch.models.cnn import init_cnn
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = HSFLConfig(rounds=1, n_uavs=8, k_select=4, n_train=400,
                     n_test=100, steps_per_epoch=2, local_epochs=3, seed=4,
                     **kw)
    p0 = init_cnn(0, "cpu")
    out = []
    for dev in (cuda, "cpu"):
        sim = HSFLSimulation(cfg, device=dev)
        sim.params = tree_map(lambda t: t.to(sim.device).clone(), p0)
        knl.reset_launches()
        log, _ = sim.run_round(1, [])
        if dev is cuda:
            single = not kw.get("batch_users", True)
            key = "conv_pool_fwd" if single else "conv_pool_fwd_k"
            if kw.get("kernel") != "im2col":
                assert knl.LAUNCHES[key] > 0
        out.append(((log.arrived_final, log.used_snapshot, log.dropped,
                     log.bytes_sent), [t.cpu() for t in
                                       tree_leaves(sim.params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert a.dtype == torch.float32
        if kw.get("precision") == "bf16":
            assert float((a - b).norm() / b.norm()) < 0.02
        else:
            assert float((a - b).abs().max()) < 1e-4


def _sweep_group(dev, **kw):
    """A tiny sweep group (2 seeds x 2 budgets, G = 4) on ``dev``, every
    draw made on the CPU; returns (metrics, final params, launches)."""
    from repro_torch.core import sweep
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.core.streams import TorchStream
    from repro_torch.kernels.delta_codec import kernel as dk
    from repro_torch.kernels.fused_cnn import kernel as knl
    base = HSFLConfig(rounds=2, n_uavs=8, k_select=4, n_train=400,
                      n_test=100, steps_per_epoch=2, local_epochs=3, **kw)
    spec = sweep.SweepSpec(base=base, seeds=(0, 1), b=(1.0, 3.0))
    group = sweep.compile_spec(spec)[0]
    data = sweep._sim_tensors(sweep._stack_sims(group), dev)
    carry, streams, cfg = sweep._group_inputs(
        group, data, dev,
        lambda c, d: TorchStream(c.seed, d, draw_on="cpu"))
    fn = sweep.build_device_round(**sweep._group_build_kwargs(group))
    knl.reset_launches()
    dk.reset_launches()
    carry, per_round = sweep._scan_rounds(fn, carry, streams, data, cfg,
                                          base.rounds)
    return (sweep._read_metrics(per_round, 2, 2), carry.params,
            {**knl.LAUNCHES, **dk.LAUNCHES})


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [False, True], ids=["f32", "codec"])
def test_device_round_on_card_matches_cpu(cuda, codec):
    """A sweep group (opt, G = 2 seeds x 2 budgets) on the card and on the
    CPU from one CPU-drawn stream: equal counts; params within 1e-4 (plus
    one quantization step of 2**-7 of the largest delta with the codec,
    which may move one lane across a .5 boundary); accuracy within one test
    image.  On the card the training kernels launch once per layer per
    step, whatever G is; the eval once per layer per round."""
    from repro_torch.utils.tree import tree_leaves
    m_g, p_g, n_g = _sweep_group(cuda, use_delta_codec=codec)
    m_c, p_c, _ = _sweep_group("cpu", use_delta_codec=codec)
    for key in ("selected", "arrived", "rescued", "delayed", "dropped"):
        assert (m_g[key] == m_c[key]).all(), key
    assert abs(m_g["test_acc"] - m_c["test_acc"]).max() <= 0.01 + 1e-9
    tol = 1e-4 + (2 ** -7 if codec else 0.0)
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        assert float((a.cpu() - b).abs().max()) < tol
    steps = 2 * 3 * 2
    assert n_g["conv_pool_fwd_k"] == 2 * steps + 2 * 2
    assert n_g["conv_pool_bwd_k"] == 2 * steps
    assert n_g["fc_chain_fwd_k"] == steps + 2
    assert n_g["fc_chain_bwd_k"] == steps
    assert n_g["quantize_blocks"] == (2 * 3 if codec else 0)
    assert n_g["dequantize_blocks"] == (2 if codec else 0)


def codec_input(m, block, bits, seed, device):
    """Gaussian rows, all-zero rows and rows whose lanes sit on exact
    k + 0.5 quanta of a power-of-two scale."""
    g = torch.Generator().manual_seed(seed)
    qmax = 2 ** (bits - 1) - 1
    x = torch.randn((m, block), generator=g) * 1e-3
    x[::7] = 0.0
    for r in range(3, m, 11):
        s = 2.0 ** -(8 + r % 5)
        k = torch.randint(-qmax, qmax, (block - 1,), generator=g).float()
        x[r, 0] = qmax * s
        x[r, 1:] = (k + 0.5) * s
    return x.to(device)


CODEC_CASES = [(m, block, bits) for m in (2560, 217) for block in (512, 128)
               for bits in (8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,block,bits", CODEC_CASES,
                         ids=[f"M{m}-block{b}-int{q}"
                              for m, b, q in CODEC_CASES])
def test_codec_kernels_match_twins_bitwise(cuda, m, block, bits):
    from repro_torch.kernels.delta_codec import kernel as knl, ref
    x = codec_input(m, block, bits, m + block + bits, cuda)
    knl.reset_launches()
    q, s = knl.quantize_blocks(x, bits=bits)
    qr, sr = ref.quantize_ref(x, bits)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(knl.dequantize_blocks(qr, sr),
                       ref.dequantize_ref(qr, sr))
    assert knl.LAUNCHES == {"quantize_blocks": 1, "dequantize_blocks": 1}
    with pytest.raises(TypeError, match="float32"):
        knl.quantize_blocks(x.double())


# every row width the register kernel is built for, and two that take the
# loop over 128-float pieces (384: no power of two; 2048: wider than a
# warp's registers), at one row, one tree and the fused round's rows
QUANT_CASES = [(m, block, bits) for m in (1, 217, 2560)
               for block in (128, 256, 512, 1024, 384, 2048)
               for bits in (8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,block,bits", QUANT_CASES,
                         ids=[f"M{m}-block{b}-int{q}"
                              for m, b, q in QUANT_CASES])
def test_quantize_kernel_every_width_bitwise(cuda, m, block, bits):
    """q and the scales bitwise equal to the twin's, with the all-zero rows
    and the rows on exact .5 quanta of ``codec_input`` (a single row: one
    on .5 quanta); one launch."""
    from repro_torch.kernels.delta_codec import kernel as knl, ref
    # one row: the tie row 3 of four
    x = codec_input(max(m, 4), block, bits, 7 * m + block + bits,
                    cuda)[-m:].contiguous()
    knl.reset_launches()
    q, s = knl.quantize_blocks(x, bits=bits)
    qr, sr = ref.quantize_ref(x, bits)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert knl.LAUNCHES["quantize_blocks"] == 1


@pytest.mark.cuda
def test_codec_round_and_server_on_card_match_cpu(cuda):
    """The fused codec round and the server, 2 rounds each on the card and
    on the CPU: equal counts; params within 1e-3, which is 1e-4 for the
    summation order plus a quantization step (deltas of ~1e-2 over 127):
    a 1e-7 difference may move one lane of a rescued snapshot across a .5
    boundary."""
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    from repro_torch.models.cnn import init_cnn
    from repro_torch.serving.fl_server import FLServer
    from repro_torch.utils.tree import tree_leaves, tree_map
    p0 = init_cnn(0, "cpu")
    for fused in (True, False):
        cfg = HSFLConfig(rounds=2, n_uavs=8, k_select=4, n_train=400,
                         n_test=100, steps_per_epoch=2, local_epochs=3,
                         seed=4, use_delta_codec=True,
                         use_fused_round=fused)
        out = []
        for dev in (cuda, "cpu"):
            if fused:
                sim = HSFLSimulation(cfg, device=dev)
                sim.params = tree_map(lambda t: t.to(sim.device).clone(), p0)
                log = sim.run()
            else:
                server = FLServer(cfg, device=dev)
                server.sim.params = tree_map(
                    lambda t: t.to(server.sim.device).clone(), p0)
                log = server.serve()
                sim = server.sim
            out.append(([(r.arrived_final, r.used_snapshot, r.dropped,
                          r.bytes_sent) for r in log.rounds],
                        [t.cpu() for t in tree_leaves(sim.params)]))
        assert out[0][0] == out[1][0]
        for a, b in zip(out[0][1], out[1][1]):
            assert float((a - b).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# the model zoo's kernels: flash attention and WKV6
# ---------------------------------------------------------------------------

# bf16 outputs: kernel and twin compute in f32 from the same bf16 inputs and
# round once, so an element differs by at most one bf16 ulp, 2**-7 of the
# largest magnitude.  The flash kernel also rounds p to bf16 before p.v on
# the tensor cores (the twin keeps p in f32): that moves an output by at
# most 2**-9 of max |v|, and far less in practice, as the rounding errors
# of the many p of a row are independent; the bound stays one ulp
ZOO_BF16_RTOL = 2 ** -7

FLASH_CASES = [
    # (B, H, KV, Sq, Sk, D, causal, window): Llama-3.2-1B's prefill shape,
    # its window and non-causal variants, a ragged S (non-causal too: the
    # causal mask hides the zero-filled tail keys from every real row; 2000
    # is no multiple of the bf16 kernel's 128-row q tile), Sq < Sk, D=32
    # and 128; at S=2048 D=32 with a group of 1 and D=128 with a group of
    # 8, and D=128 ragged and non-causal
    (2, 32, 8, 2048, 2048, 64, True, 0),
    (2, 32, 8, 2048, 2048, 64, True, 256),
    (2, 32, 8, 2048, 2048, 64, False, 0),
    (2, 32, 8, 2000, 2000, 64, True, 0),
    (2, 32, 8, 2000, 2000, 64, False, 0),
    (1, 4, 2, 100, 300, 64, True, 0),
    (2, 4, 2, 128, 128, 32, True, 20),
    (1, 8, 1, 256, 256, 128, True, 0),
    (1, 8, 8, 2048, 2048, 32, True, 0),
    (1, 8, 1, 2048, 2048, 128, True, 0),
    (1, 8, 1, 2000, 2000, 128, False, 0),
    # D=80 (hubert-xlarge: 16 q and 16 kv heads, non-causal, S=1500 frames
    # of 30 s of audio, ragged against both kernels' tiles), causal, and a
    # ragged causal S with groups of 2
    (1, 16, 16, 1500, 1500, 80, False, 0),
    (2, 8, 8, 512, 512, 80, True, 0),
    (1, 4, 2, 200, 200, 80, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"S{c[3]}x{c[4]}-D{c[5]}-c{int(c[6])}-w{c[7]}"
                              for c in FLASH_CASES])
def test_flash_attention_kernel_matches_twin(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import kernel as knl, ref
    b, h, kv, sq, sk, d, causal, window = case
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(cuda).manual_seed(sq + d)
    q = torch.randn(b * h, sq, d, device=cuda, generator=g).to(dt)
    k = torch.randn(b * kv, sk, d, device=cuda, generator=g).to(dt)
    v = torch.randn(b * kv, sk, d, device=cuda, generator=g).to(dt)
    n0 = knl.LAUNCHES["flash_attention_bh"]
    got = knl.flash_attention_bh(q, k, v, group_size=h // kv, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert knl.LAUNCHES["flash_attention_bh"] == n0 + 1
    want = ref.flash_attention_bh_ref(q, k, v, h // kv, causal, window)
    assert got.dtype == dt
    _within(got.float(), want.float(),
            RTOL if dtype == "f32" else ZOO_BF16_RTOL)


# the zoo's other families' attention (B, H, KV, S, D): granite-moe (G=3),
# hymba (G=5; 25 q heads, so B·H is odd at B = 1 and 3) and qwen2-vl
# (G=6, D=128), causal, at their prefill length and ragged
FAMILY_FLASH_CASES = [(2, 24, 8, 2048, 64), (1, 24, 8, 300, 64),
                      (1, 25, 5, 2048, 64), (3, 25, 5, 300, 64),
                      (2, 12, 2, 2048, 128), (1, 12, 2, 300, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FAMILY_FLASH_CASES,
                         ids=[f"B{c[0]}-H{c[1]}-KV{c[2]}-S{c[3]}-D{c[4]}"
                              for c in FAMILY_FLASH_CASES])
def test_flash_attention_family_group_sizes(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import kernel as knl, ref
    b, h, kv, s, d = case
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(cuda).manual_seed(b * h + s + d)
    q = torch.randn(b * h, s, d, device=cuda, generator=g).to(dt)
    k = torch.randn(b * kv, s, d, device=cuda, generator=g).to(dt)
    v = torch.randn(b * kv, s, d, device=cuda, generator=g).to(dt)
    got = knl.flash_attention_bh(q, k, v, group_size=h // kv)
    torch.cuda.synchronize()
    want = ref.flash_attention_bh_ref(q, k, v, h // kv, True, 0)
    _within(got.float(), want.float(),
            RTOL if dtype == "f32" else ZOO_BF16_RTOL)


# the f32 kernel's masks at every head dim: (label, Sq, Sk, causal, window);
# 300 is ragged against its 128-row q tiles and 64-row k tiles, and a
# window of 20 is narrower than a tile
F32_MASKS = [("causal", 256, 256, True, 0), ("window20", 256, 256, True, 20),
             ("window256", 600, 600, True, 256),
             ("noncausal", 256, 256, False, 0),
             ("ragged-causal", 300, 300, True, 0),
             ("ragged-noncausal", 300, 300, False, 0),
             ("sq100-sk300", 100, 300, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("mask", F32_MASKS, ids=[m[0] for m in F32_MASKS])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_attention_f32_every_head_dim_and_mask(cuda, d, mask, group):
    """The f32 kernel against its twin within 1e-5 of the largest, at
    every head dim it is built for, each mask and GQA groups of 1 and 4
    (B=2, 2 kv heads); a second launch gives the same bits."""
    from repro_torch.kernels.flash_attention import kernel as knl, ref
    assert d in knl.HEAD_DIMS
    _, sq, sk, causal, window = mask
    g = torch.Generator(cuda).manual_seed(d * 1000 + sq + sk + group)
    q = torch.randn(2 * 2 * group, sq, d, device=cuda, generator=g)
    k, v = (torch.randn(2 * 2, sk, d, device=cuda, generator=g)
            for _ in range(2))
    got = knl.flash_attention_bh(q, k, v, group_size=group, causal=causal,
                                 window=window)
    again = knl.flash_attention_bh(q, k, v, group_size=group, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_bh_ref(q, k, v, group, causal, window)
    _within(got, want, RTOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_kernel_takes_more_than_65535_rows(cuda, dtype):
    """B·H = 65 600 q rows (8200 kv rows, groups of 8) on a short S (72,
    ragged against the 64-row tiles): past the 65 535 blocks a grid axis
    other than x may hold, against the twin."""
    from repro_torch.kernels.flash_attention import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(cuda).manual_seed(12)
    q = torch.randn(65600, 72, 32, device=cuda, generator=g).to(dt)
    k, v = (torch.randn(8200, 72, 32, device=cuda, generator=g).to(dt)
            for _ in range(2))
    got = knl.flash_attention_bh(q, k, v, group_size=8)
    torch.cuda.synchronize()
    want = ref.flash_attention_bh_ref(q, k, v, 8, True, 0)
    _within(got.float(), want.float(),
            RTOL if dtype == "f32" else ZOO_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits: every sum of
    both kernels runs in a fixed order (no atomics)."""
    from repro_torch.kernels.flash_attention import kernel as knl
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(cuda).manual_seed(11)
    q, k, v = (torch.randn(n, 2000, 64, device=cuda, generator=g).to(dt)
               for n in (16, 4, 4))
    for causal in (True, False):
        a = knl.flash_attention_bh(q, k, v, group_size=4, causal=causal)
        b = knl.flash_attention_bh(q, k, v, group_size=4, causal=causal)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,bs", [(10, 10), (3, 7), (1, 1000)],
                         ids=["main-K10-B10", "odd-K3-B7", "eval-K1-B1000"])
def test_fc_chain_fwd_kernel_is_deterministic_in_one_launch(cuda, k, bs,
                                                            dtype):
    """The blocked fc forward at the round's, an odd cohort's and the
    eval's shapes: within the twin's tolerance, the same bits on two calls
    (the per-tile counter only picks the block that runs layers 2 and 3,
    and the kernel leaves it at 0), one launch a call."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    params, _ = _cohort(k, bs, 7, cuda)
    params = _cast(params, dt)
    flat = torch.relu(torch.randn((k, bs, 784), device=cuda)).to(dt)
    knl.reset_launches()
    la, ra = knl.fc_chain_fwd_k(flat, params)
    lb, rb = knl.fc_chain_fwd_k(flat, params)
    assert knl.LAUNCHES["fc_chain_fwd_k"] == 2
    lp, rp = ref.fc_chain_fwd_k(flat, params)
    for a, b, want in zip((la, *ra), (lb, *rb), (lp, *rp)):
        assert a.dtype == dt and torch.equal(a, b)
        _within(a, want, RTOL if dtype == "f32" else BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,bs,widths", [
    (2, 3, (30, 20, 12, 5)), (1, 2, (64, 256, 256, 8))],
    ids=["odd-widths", "wide-fc2"])
def test_fc_chain_fwd_kernel_other_widths_match_twin(cuda, k, bs, widths,
                                                     dtype):
    """Widths off the CNN's: rows of x and W1 that are no whole 16 bytes
    (staged with cp.async, not the TMA unit) and a ragged column tile; and
    an fc2 too wide for shared memory (the last block reads W2 from global
    memory)."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    f, d1, d2, d3 = widths
    g = torch.Generator(cuda).manual_seed(f + d1)
    params = {}
    for name, (fin, fout) in (("fc1", (f, d1)), ("fc2", (d1, d2)),
                              ("fc3", (d2, d3))):
        params[name] = {
            "w": (torch.randn(k, fin, fout, device=cuda, generator=g)
                  * fin ** -0.5).to(dt),
            "b": (torch.randn(k, fout, device=cuda, generator=g) * 0.1)
            .to(dt)}
    flat = torch.relu(torch.randn((k, bs, f), device=cuda,
                                  generator=g)).to(dt)
    lk, rk = knl.fc_chain_fwd_k(flat, params)
    lp, rp = ref.fc_chain_fwd_k(flat, params)
    for got, want in zip((lk, *rk), (lp, *rp)):
        assert got.dtype == dt
        _within(got, want, RTOL if dtype == "f32" else BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fc_chain_bwd_kernel_is_deterministic_in_one_launch(cuda, dtype):
    """The blocked fc backward on the main path's cohort: two calls give
    the same bits (no float atomics), and each call is one launch."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    params, _ = _cohort(10, 10, 6, cuda)
    params = _cast(params, dt)
    flat = torch.relu(torch.randn((10, 10, 784), device=cuda)).to(dt)
    _, res = ref.fc_chain_fwd_k(flat, params)
    g = (torch.randn((10, 10, 10), device=cuda) * 0.1).to(dt)
    knl.reset_launches()
    ga, da = knl.fc_chain_bwd_k(flat, res, params, g)
    gb, db = knl.fc_chain_bwd_k(flat, res, params, g)
    assert knl.LAUNCHES["fc_chain_bwd_k"] == 2
    assert torch.equal(da, db)
    for layer in ga:
        for leaf in ga[layer]:
            assert torch.equal(ga[layer][leaf], gb[layer][leaf])


def _wkv_inputs(bh, s, d, dt, device):
    g = torch.Generator(device).manual_seed(s + d)
    r, k, v = (torch.randn(bh, s, d, device=device, generator=g).mul(0.5)
               .to(dt) for _ in range(3))
    w = torch.rand(bh, s, d, device=device, generator=g) * 0.4 + 0.55
    u = torch.randn(bh, d, device=device, generator=g) * 0.1
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bh,s,d", [(128, 2048, 64), (16, 77, 32),
                                    (32, 300, 128), (3, 1, 64)],
                         ids=["rwkv6-7b", "ragged-D32", "ragged-D128", "S1"])
def test_wkv6_kernel_matches_twin(cuda, bh, s, d, dtype):
    """r, k, v in the compute dtype, w and u in f32, as the model feeds
    them; y and the final state."""
    from repro_torch.kernels.wkv6 import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    r, k, v, w, u = _wkv_inputs(bh, s, d, dt, cuda)
    y, sf = knl.wkv6_bh(r, k, v, w, u)
    torch.cuda.synchronize()
    yr, sr = ref.wkv6_bh_ref(r, k, v, w, u)
    assert y.dtype == dt and sf.dtype == torch.float32
    _within(y.float(), yr.float(), RTOL if dtype == "f32" else ZOO_BF16_RTOL)
    _within(sf, sr, RTOL)
    with pytest.raises(TypeError, match="float32"):
        knl.wkv6_bh(r, k, v, w.to(torch.bfloat16), u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_kernel_every_head_dim(cuda, dtype):
    """Every head dim the kernel is built for, on a ragged S (no multiple
    of its 16-step chunks) against the twin, inputs that do not start on
    16 bytes included; any other head dim raises, naming the list."""
    from repro_torch.kernels.wkv6 import kernel as knl, ref
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    for d in knl.HEAD_DIMS:
        r, k, v, w, u = _wkv_inputs(5, 45, d, dt, cuda)
        y, sf = knl.wkv6_bh(r, k, v, w, u)
        yr, sr = ref.wkv6_bh_ref(r, k, v, w, u)
        _within(y.float(), yr.float(),
                RTOL if dtype == "f32" else ZOO_BF16_RTOL)
        _within(sf, sr, RTOL)
    r, k, v, w, u = _wkv_inputs(4, 33, 64, dt, cuda)
    shifted = [torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)[1:]
               .view(a.shape).copy_(a) for a in (r, k, v, w)]
    assert all(a.data_ptr() % 16 for a in shifted)
    y, sf = knl.wkv6_bh(*shifted, u)
    yr, sr = ref.wkv6_bh_ref(r, k, v, w, u)
    _within(y.float(), yr.float(), RTOL if dtype == "f32" else ZOO_BF16_RTOL)
    _within(sf, sr, RTOL)
    r, k, v, w, u = _wkv_inputs(2, 8, 40, dt, cuda)
    with pytest.raises(ValueError, match="head dim 40 not in"):
        knl.wkv6_bh(r, k, v, w, u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_kernel_is_deterministic_in_one_launch(cuda, dtype):
    """At RWKV6-7B's prefill shape two calls give the same bits (every sum
    in a fixed order, no atomics), each one launch."""
    from repro_torch.kernels.wkv6 import kernel as knl
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    r, k, v, w, u = _wkv_inputs(128, 2048, 64, dt, cuda)
    knl.reset_launches()
    ya, sa = knl.wkv6_bh(r, k, v, w, u)
    yb, sb = knl.wkv6_bh(r, k, v, w, u)
    assert knl.LAUNCHES["wkv6_bh"] == 2
    assert torch.equal(ya, yb) and torch.equal(sa, sb)


def _zoo_model(name, dtype, device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    if name == "rwkv6":
        cfg = get_config("rwkv6-7b").reduced()
    else:
        cfg = get_config("llama3.2-1b").reduced().replace(num_kv_heads=2)
    return build_model(cfg.replace(dtype=dtype), device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama", "rwkv6"])
def test_prefill_launches_one_kernel_per_layer(cuda, name):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.training.step import make_prefill_step
    model = _zoo_model(name, "bfloat16", cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 256), device=cuda)
    fa.reset_launches()
    wk.reset_launches()
    logits = make_prefill_step(model)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())
    layers = model.cfg.num_layers
    assert fa.LAUNCHES["flash_attention_bh"] == (0 if name == "rwkv6"
                                                 else layers)
    assert wk.LAUNCHES["wkv6_bh"] == (layers if name == "rwkv6" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["llama", "rwkv6"])
def test_zoo_forward_on_card_matches_cpu(cuda, name, dtype):
    """The card's kernel path against the CPU twins at reduced size, from
    one set of params: logits (f32 within 1e-4 of the largest magnitude,
    bf16 within 3% relative Frobenius, the CPU tests' bounds against JAX)
    and, at f32, the greedy tokens."""
    from repro_torch.serving import generate
    from repro_torch.utils.tree import tree_map
    m_cpu = _zoo_model(name, dtype, "cpu")
    m_gpu = _zoo_model(name, dtype, cuda)
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    tokens = torch.randint(0, m_cpu.cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    want, _ = m_cpu.forward(p_cpu, {"tokens": tokens})
    got, _ = m_gpu.forward(p_gpu, {"tokens": tokens.to(cuda)})
    got, want = got.float().cpu(), want.float()
    if dtype == "float32":
        _within(got, want, 1e-4)
        prompt = tokens[:, :12]
        t_cpu = generate(m_cpu, p_cpu, prompt, max_new=8, context_len=20)
        t_gpu = generate(m_gpu, p_gpu, prompt.to(cuda), max_new=8,
                         context_len=20)
        assert torch.equal(t_gpu.cpu(), t_cpu)
    else:
        assert float((got - want).norm() / want.norm()) <= 0.03


FAMILIES = {"granite": ("granite-moe-3b-a800m", 2), "hymba": ("hymba-1.5b", 2),
            "qwen2-vl": ("qwen2-vl-2b", None),
            "hubert": ("hubert-xlarge", None)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_on_card_matches_cpu(cuda, name, dtype):
    """The moe, hybrid, vlm and audio families reduced (granite and hymba
    with 2 kv heads): one flash launch a layer, and the card's path
    against the CPU twins from one set of params and inputs, on the real
    vocabulary (f32 1e-4 of the largest, bf16 3% relative Frobenius) and,
    for the decoders at f32, the greedy tokens.  moe at bf16 (as
    ``chip_smoke.zoo_card_vs_cpu``): a router probability that rounds
    the other way moves a token's expert, so the dense dispatch runs, the
    tokens whose routes moved are counted (at most 10%) and the bound
    holds over the others."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import build_model, inputs, moe
    from repro_torch.serving import generate
    from repro_torch.utils.tree import tree_map
    arch, kv = FAMILIES[name]
    cfg = get_config(arch).reduced().replace(dtype=dtype)
    if kv:
        cfg = cfg.replace(num_kv_heads=kv)
    m_cpu, m_gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    batch = inputs.materialize(inputs.prefill_specs(cfg, 2, 128), cfg,
                               seed=1, device="cpu")
    routed = bool(cfg.num_experts) and dtype == "bfloat16"
    opts = {"moe_dispatch": "dense"} if routed else None
    plain, routes = moe.top_k, []

    def recorded(probs, k):                    # the set of experts
        w, e = plain(probs, k)
        routes.append(torch.sort(e, dim=-1).values.cpu())
        return w, e

    moe.top_k = recorded
    try:
        want, _ = m_cpu.forward(p_cpu, batch, opts)
        fa.reset_launches()
        got, _ = m_gpu.forward(p_gpu, {k: v.to(cuda)
                                       for k, v in batch.items()}, opts)
        torch.cuda.synchronize()
    finally:
        moe.top_k = plain
    assert fa.LAUNCHES["flash_attention_bh"] == cfg.num_layers
    V = cfg.vocab_size
    got, want = got[..., :V].float().cpu(), want[..., :V].float()
    if routed:
        n = len(routes) // 2
        kept = torch.ones(got.shape[:2], dtype=torch.bool)
        for a, b in zip(routes[:n], routes[n:]):
            kept &= (a == b).all(-1).reshape(kept.shape)
        assert 1.0 - float(kept.float().mean()) <= 0.10
        got, want = got[kept], want[kept]
    if dtype == "bfloat16":
        assert float((got - want).norm() / want.norm()) <= 0.03
        return
    _within(got, want, 1e-4)
    if not cfg.is_encoder_only:
        prompt = batch["tokens"][:, :12]
        t_cpu = generate(m_cpu, p_cpu, prompt, max_new=8, context_len=20)
        t_gpu = generate(m_gpu, p_gpu, prompt.to(cuda), max_new=8,
                         context_len=20)
        assert torch.equal(t_gpu.cpu(), t_cpu)


@pytest.mark.cuda
def test_zoo_kernels_refuse_autograd_on_the_card(cuda):
    """No gradient is cut silently on the card either: both wrappers raise
    on CUDA tensors that require a gradient, and launch nothing."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.wkv6 import kernel as wk
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(4, 64, 64, device=cuda, generator=g)
               for _ in range(3))
    w = torch.rand(4, 64, 64, device=cuda, generator=g)
    u = torch.randn(4, 64, device=cuda, generator=g)
    fa.reset_launches()
    wk.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_bh(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        wk.wkv6_bh(q, k, v, w, u)
    assert fa.LAUNCHES["flash_attention_bh"] == wk.LAUNCHES["wkv6_bh"] == 0
    with torch.no_grad():
        fa.flash_attention_bh(q, k, v)
        wk.wkv6_bh(q, k, v, w, u)
    assert fa.LAUNCHES["flash_attention_bh"] == wk.LAUNCHES["wkv6_bh"] == 1


# the moe dispatch kernels' cases (T, k, E, d, skew): granite-prefill-chat's
# batch (T 18432, top-8 of 40, d 1536) with routes drawn with weights
# exp(skew·e), so that the high experts overflow their capacity, and a
# small ragged shape at k = 1
MOE_CASES = {"cell": (18432, 8, 40, 1536, 0.05), "small": (333, 1, 16, 64, 0.3)}


def _moe_case(case, dtype, device):
    """x (T, d), flat_e (T·k,) token-major with k distinct experts a
    token, flat_w (T·k,), the capacity C, and (T, k, E)."""
    from repro_torch.models import moe
    T, k, E, d, skew = MOE_CASES[case]
    g = torch.Generator().manual_seed(T + k)
    w = torch.exp(skew * torch.arange(E, dtype=torch.float64))
    flat_e = torch.multinomial(w.expand(T, E), k, replacement=False,
                               generator=g).reshape(T * k)
    x = torch.randn(T, d, generator=g).to(dtype)
    flat_w = torch.rand(T * k, generator=g).to(dtype)
    C = max(8, int(moe.CAPACITY_FACTOR * T * k / E + 0.5))
    return (x.to(device), flat_e.to(device), flat_w.to(device), C,
            (T, k, E))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dispatch_kernels_equal_the_plain_path(cuda, case, dtype):
    """Slots, keep, counts and the (E, C, d) buffer equal the plain code's
    (``ref.slots_ref``, ``ref.scatter_ref``: its one-hot cumsum,
    repeat_interleave and index_copy_ on the card) bit for bit, some
    routes dropped; the combine equals its twin bit for bit
    (both sum the rounded products in f32 in route order, __fadd_rn
    against torch's add) and the plain ``_combine`` within the f32 sums'
    reordering (2**-20 of the products' magnitudes at k <= 8) plus, at
    bf16, one bf16 ulp of the output (2**-7 of its magnitude): the same
    products, summed in f32 in another order, each rounded once."""
    from repro_torch.kernels.moe_dispatch import kernel as mk, ref as mr
    from repro_torch.models import moe
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, flat_e, flat_w, C, (T, k, E) = _moe_case(case, dt, cuda)
    d = x.shape[1]
    mk.reset_launches()
    slot, keep, counts = mk.moe_slots(flat_e, E, C)
    want_slot, want_keep, want_counts = mr.slots_ref(flat_e, E, C)
    assert torch.equal(slot, want_slot) and torch.equal(keep, want_keep)
    assert not bool(keep.all())
    assert torch.equal(counts, want_counts)
    assert torch.equal(counts.long(), torch.bincount(flat_e, minlength=E))
    buf = mk.moe_scatter(x, slot, counts, E, C, k)
    assert torch.equal(buf, mr.scatter_ref(x, want_slot, E, C, k))
    out = torch.randn(E, C, d, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(5)).to(dt)
    y = mk.moe_combine(out, slot, flat_w, k)
    torch.cuda.synchronize()
    assert torch.equal(y, mr.combine_ref(out, slot, flat_w, k))
    plain = moe._combine(out, slot, keep, flat_w, T, 1, k).reshape(T, d)
    rows = torch.cat([out.reshape(E * C, d),
                      torch.zeros(1, d, dtype=dt, device=cuda)])
    prods = (rows[slot].float() * flat_w.float()[:, None]).abs()
    room = 2 ** -20 * prods.reshape(T, k, d).sum(1)
    if dt == torch.bfloat16:
        room = room + 2 ** -7 * plain.float().abs()
    assert bool(((y.float() - plain.float()).abs() <= room).all())
    assert mk.LAUNCHES == {"moe_slots": 1, "moe_scatter": 1,
                           "moe_combine": 1}


@pytest.mark.cuda
def test_moe_dispatch_kernels_are_deterministic(cuda):
    """Two runs of the three kernels at the cell's shape: the same bits
    (the slot counts' shared-memory atomics add in any order; a count has
    none)."""
    from repro_torch.kernels.moe_dispatch import kernel as mk
    x, flat_e, flat_w, C, (T, k, E) = _moe_case("cell", torch.bfloat16, cuda)
    runs = []
    for _ in range(2):
        slot, keep, counts = mk.moe_slots(flat_e, E, C)
        buf = mk.moe_scatter(x, slot, counts, E, C, k)
        runs.append((slot, keep, counts, buf,
                     mk.moe_combine(buf, slot, flat_w, k)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_layer_takes_the_kernels_outside_autograd_only(cuda):
    """Granite's layer at its full width (reduced depth does not matter to
    one layer) on a batch of 4 x 512 tokens: on plain tensors one launch of
    each wrapper and ``moe.dispatch_kernel`` 1; where autograd records,
    no launch and no count, and the plain path's output within the
    combine's reordering of the kernels'."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import kernel as mk
    from repro_torch.models import moe
    from repro_torch.utils import trace
    cfg = get_config("granite-moe-3b-a800m")
    p = moe.init_moe(torch.Generator(cuda).manual_seed(0), cfg, cuda)
    x = torch.randn(4, 512, cfg.d_model, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    mk.reset_launches()
    with trace.record() as rec:
        y, aux = moe.moe_ffn(p, cfg, x)
    assert mk.LAUNCHES == {"moe_slots": 1, "moe_scatter": 1,
                           "moe_combine": 1}
    assert rec.counters["moe.dispatch_kernel"] == 1
    xg = x.clone().requires_grad_(True)
    with trace.record() as rec_g:
        yg, aux_g = moe.moe_ffn(p, cfg, xg)
    assert mk.LAUNCHES == {"moe_slots": 1, "moe_scatter": 1,
                           "moe_combine": 1}
    assert "moe.dispatch_kernel" not in rec_g.counters
    assert rec_g.counters["moe.dropped_routes"] == \
        rec.counters["moe.dropped_routes"]
    assert torch.equal(aux, aux_g.detach())
    scale = float(yg.detach().float().abs().max())
    assert float((y.float() - yg.detach().float()).abs().max()) <= \
        (2 ** -7 + 8 * 2 ** -20) * scale
    with pytest.raises(RuntimeError, match="no backward"):
        mk.moe_scatter(xg.reshape(-1, cfg.d_model),
                       torch.zeros(2048 * 8, dtype=torch.int64, device=cuda),
                       torch.zeros(40, dtype=torch.int32, device=cuda),
                       40, 8, 8)
    assert mk.LAUNCHES["moe_scatter"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama", "rwkv6"])
def test_train_step_on_card_matches_cpu_and_launches_no_kernel(cuda, name):
    """One AdamW step (clip 1.0) at f32 from one set of params: the card
    against the CPU, loss within 1e-5 relative and params within 1e-4 of
    the largest magnitude (the CPU tests' bounds against JAX); the step
    launches no kernel, and a no_grad prefill after it one a layer."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import inputs
    from repro_torch.optim import adamw, cosine
    from repro_torch.training import (create_train_state, make_prefill_step,
                                      make_train_step)
    from repro_torch.utils.tree import tree_leaves, tree_map
    m_cpu = _zoo_model(name, "float32", "cpu")
    m_gpu = _zoo_model(name, "float32", cuda)
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    batch = inputs.materialize(inputs.train_specs(m_cpu.cfg, 2, 64),
                               m_cpu.cfg, seed=1, device="cpu")
    out = {}
    for m, dev in ((m_cpu, "cpu"), (m_gpu, cuda)):
        opt = adamw(cosine(3e-4, 1, 4), weight_decay=0.1)
        state = create_train_state(tree_map(lambda t: t.to(dev), p_cpu), opt)
        fa.reset_launches()
        wk.reset_launches()
        state, met = make_train_step(m, opt, grad_clip=1.0)(
            state, {k: v.to(dev) for k, v in batch.items()})
        assert fa.LAUNCHES["flash_attention_bh"] == 0
        assert wk.LAUNCHES["wkv6_bh"] == 0
        out[str(dev)] = (float(met["loss"]), state)
    (l_cpu, s_cpu), (l_gpu, s_gpu) = out["cpu"], out[str(cuda)]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    scale = max(float(t.abs().max()) for t in tree_leaves(s_cpu.params))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)))
    assert err <= 1e-4 * scale, (err, scale)
    assert int(s_gpu.step) == 1 and s_gpu.step.device.type == "cuda"
    make_prefill_step(m_gpu)(s_gpu.params, {"tokens": batch["tokens"].to(
        cuda)})
    torch.cuda.synchronize()
    layers = m_gpu.cfg.num_layers
    assert (fa.LAUNCHES["flash_attention_bh"], wk.LAUNCHES["wkv6_bh"]) == (
        (0, layers) if name == "rwkv6" else (layers, 0))


# ---------------------------------------------------------------------------
# ranks on the card: OpportunisticSync and the sweep (gloo: they share it)
# ---------------------------------------------------------------------------

OPP_E = 4


def _opp_rank(rank, world, device, rounds):
    """``rounds`` OpportunisticSync rounds of a reduced llama at f32 (params
    from a CPU generator, the trace from seed 3, in which pod 1 snapshots
    in both rounds and is rescued in the first): per round the losses,
    the snapshot slots at each step's entry and the params; and whether a
    state spanning two devices is refused."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.opportunistic_sync import (OppSyncConfig,
                                                     channel_trace,
                                                     make_opp_sync_round)
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves
    cfg = OppSyncConfig(inner_steps=OPP_E, budget=2, outage_prob=0.5)
    model = build_model(get_config("llama3.2-1b").reduced(), device)
    opt = sgd(1e-2)
    state = create_train_state(
        model.init(torch.Generator().manual_seed(0)), opt,
        with_opt_sync=True, tau_extra0=cfg.tau_extra0)
    step, seen = make_train_step(model, opt), []

    def recorded(st, batch):
        seen.append((int(st.snapshot_step), float(st.tau_extra)))
        return step(st, batch)
    one_round = make_opp_sync_round(cfg, recorded)
    rates, outages, arrived = channel_trace(
        cfg, torch.Generator().manual_seed(3), world, rounds)
    gen = torch.Generator().manual_seed(2)
    out = []
    for r in range(rounds):
        toks = torch.randint(0, 512, (world, OPP_E, 2, 16), generator=gen)
        seen.clear()
        state, losses = one_round(
            state, {"tokens": toks[rank].to(device),
                    "labels": toks.roll(1, -1)[rank].to(device)},
            rates[r], outages[r], arrived[r])
        same = True
        for leaf in tree_leaves(state.params):
            ref = leaf.clone()
            dist.broadcast(ref, src=0)
            same = same and torch.equal(ref, leaf)
        out.append((losses.cpu(), list(seen), same,
                    [t.cpu() for t in tree_leaves(state.params)]))
    refused = ""
    if device.type == "cuda":
        mixed = state._replace(snapshot_step=state.snapshot_step.cpu())
        try:
            one_round(mixed, {}, rates[0], outages[0], arrived[0])
        except ValueError as err:
            refused = str(err)
    return out, refused


@pytest.mark.cuda
def test_opp_sync_ranks_on_the_card_match_the_cpu(cuda, tmp_path):
    """Two ranks share the card through gloo (CUDA tensors, collectives
    through the host): the pods end every round bitwise equal, and the
    card matches two CPU ranks (decisions exact, loss 1e-5 relative,
    params 1e-4 of the largest); a state spanning two devices is
    refused."""
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    assert backend_for(2, torch.cuda.device_count(), "cuda") == (
        "gloo" if torch.cuda.device_count() < 2 else "nccl")
    card = spawn_ranks(_opp_rank, 2, None, args=(2,), tmpdir=str(tmp_path))
    cpu = spawn_ranks(_opp_rank, 2, "cpu", args=(2,), tmpdir=str(tmp_path))
    assert any(seen[0] >= 0 for _, sg, _, _ in card[1][0] for seen in sg)
    for rank in range(2):
        (got, refused), (want, _) = card[rank], cpu[rank]
        assert "spans devices" in refused
        for (lg, sg, eq, pg), (lc, sc, _, pc) in zip(got, want):
            assert eq and sg == sc
            assert torch.all((lg - lc).abs() <= 1e-5 * lc.abs())
            scale = max(float(t.abs().max()) for t in pc)
            assert max(float((a - b).abs().max())
                       for a, b in zip(pg, pc)) <= 1e-4 * scale


def _card_sweep_rank(rank, world, device):
    from repro_torch.core import sweep
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.launch.mesh import make_sweep_mesh
    spec = sweep.SweepSpec(
        base=HSFLConfig(rounds=2, n_uavs=8, k_select=4, n_train=400,
                        n_test=100, steps_per_epoch=2, local_epochs=4),
        seeds=(0, 1), schemes=(("opt", {"b": 2.0}), ("async", {"b": 1.0})))
    sharded = sweep._run_sweep(spec, mesh=make_sweep_mesh(), device=device)
    alone = sweep._run_sweep(spec, mesh=None, device=device)
    return sharded, alone


@pytest.mark.cuda
def test_sweep_over_two_ranks_on_the_card_is_bitwise_unsharded(cuda,
                                                                tmp_path):
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.utils.tree import tree_leaves
    for sharded, alone in spawn_ranks(_card_sweep_rank, 2, None,
                                      tmpdir=str(tmp_path)):
        for g, w in zip(sharded.groups, alone.groups):
            for k in w.metrics:
                assert np.array_equal(g.metrics[k], w.metrics[k]), k
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(g.final_params), tree_leaves(w.final_params)))


# ---------------------------------------------------------------------------
# the runtime guards (repro_torch.analysis.guards) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_transfer_guards_bite_on_the_card(cuda):
    from repro_torch.analysis.guards import (ImplicitTransfer,
                                             no_implicit_transfers)
    staged = torch.ones(4, device=cuda)
    with no_implicit_transfers():
        with pytest.raises(ImplicitTransfer, match="_to_copy"):
            torch.ones(4).cuda()
        with pytest.raises(ImplicitTransfer, match="tensor"):
            torch.tensor([1.0, 2.0], device=cuda)
        with pytest.raises(ImplicitTransfer, match="copy_"):
            staged.copy_(torch.zeros(4))
        assert (staged + 1).sum().item() == 8.0   # reads stay legal
        staged.to(torch.bfloat16)
    for direction in ("device_to_host", "all"):
        with no_implicit_transfers(direction):
            with pytest.raises(RuntimeError, match="synchroniz"):
                (staged + 1).sum().item()
        assert torch.cuda.get_sync_debug_mode() == 0


def _guarded_round(cuda, codec):
    from repro_torch.analysis import contracts as tc
    from repro_torch.core.channel_lib import ChannelParams
    from repro_torch.core.fused_round import build_device_round
    from repro_torch.kernels import _build
    _build.build_all()
    fn = build_device_round(
        scheme="opt", local_epochs=2, steps_per_epoch=1, batch_size=4,
        lr=0.01, k_select=4, channel=ChannelParams(), model_bytes=1e6,
        ue_model_fraction=0.25, use_codec=codec)
    # per round: 2 epochs x 1 step (2 conv fwd, 2 conv bwd, 1 fc fwd, 1 fc
    # bwd launches each) and one eval (2 conv fwd, 1 fc fwd); the codec
    # quantizes every epoch and dequantizes once
    want = {"conv_pool_fwd_k": 6, "conv_pool_bwd_k": 4, "fc_chain_fwd_k": 3,
            "fc_chain_bwd_k": 2}
    if codec:
        want.update(quantize_blocks=2, dequantize_blocks=1)
    return fn, tc.device_round_inputs(cuda), want


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [False, True])
def test_device_round_under_engine_guard_on_the_card(cuda, codec):
    from repro_torch.analysis.guards import (LaunchBudgetExceeded,
                                             engine_guard,
                                             no_implicit_transfers)
    fn, (carry, stream, sim, cfg), want = _guarded_round(cuda, codec)
    budget = 2 * sum(want.values())
    with engine_guard(budget=budget) as lc:
        for t in (1, 2):
            carry, metrics = fn(carry, t, stream, sim, cfg)
    assert lc.launches() == {k: 2 * v for k, v in want.items()}
    assert lc.count() == budget and lc.builds == []
    assert bool(torch.isfinite(metrics.test_loss).all())
    with pytest.raises(LaunchBudgetExceeded, match=f"budget is {budget - 1}"):
        with engine_guard(budget=budget - 1):
            for t in (3, 4):
                carry, metrics = fn(carry, t, stream, sim, cfg)
    with no_implicit_transfers("all"):
        with pytest.raises(RuntimeError, match="synchroniz"):
            metrics.test_acc[0].item()


# ---------------------------------------------------------------------------
# import hygiene: runs everywhere
# ---------------------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "msgpack"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, "\n".join(bad)
    walked = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
              for p in _port_files()[:-1]}
    assert {"checkpoint", "configs", "core", "kernels", "launch", "models",
            "serving", "sharding", "training"} <= walked
    assert len(_port_files()) > 30


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core.hsfl, repro_torch.kernels._build, "
            "repro_torch.kernels.fused_cnn.kernel, "
            "repro_torch.kernels.fused_cnn.ops, "
            "repro_torch.core.fused_round, repro_torch.models.cnn, "
            "repro_torch.kernels.delta_codec.kernel, "
            "repro_torch.serving.fl_server, repro_torch.launch.serve_fl, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.models.attention, repro_torch.models.layers, "
            "repro_torch.models.rope, repro_torch.models.rwkv6, "
            "repro_torch.models.transformer, "
            "repro_torch.kernels.flash_attention.kernel, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.wkv6.kernel, repro_torch.kernels.wkv6.ops, "
            "repro_torch.serving.decode, repro_torch.training.step, "
            "repro_torch.launch.serve, repro_torch.optim, "
            "repro_torch.training, repro_torch.launch.train, "
            "repro_torch.core.split, repro_torch.data, repro_torch.convert, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.serve_batched, "
            "repro_torch.examples.uav_fl_sim, "
            "repro_torch.core.opportunistic_sync, repro_torch.launch.mesh, "
            "repro_torch.sharding.rules, "
            "repro_torch.examples.opportunistic_multipod, "
            "repro_torch.analysis, repro_torch.analysis.contracts, "
            "repro_torch.analysis.guards, repro_torch.analysis.rules\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_device_engine_modules_load_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.core.sweep, "
            "repro_torch.core.streams, repro_torch.core.channel_lib, "
            "repro_torch.core.selection\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_experiment_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.api import Experiment
    from repro_torch.core.hsfl import HSFLConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = Experiment(HSFLConfig(rounds=1, n_uavs=4, k_select=2, n_train=100,
                               n_test=20))
    for engine in ("auto", "sweep", "fused", "loop"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.run(engine=engine)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.serve()


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """``device=None`` means the card; without one it raises instead of
    running on the CPU."""
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation, run_hsfl
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HSFLConfig(rounds=1, n_uavs=4, k_select=2, n_train=100,
                     n_test=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HSFLSimulation(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_hsfl(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from repro_torch.models.cnn import init_cnn
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cnn(0)
    from repro_torch.launch import serve_fl
    from repro_torch.serving.fl_server import FLServer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLServer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_fl.main(["--rounds", "1", "--quiet"])
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    zoo = get_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(zoo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--max-new", "2", "--prompt-len", "2"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert HSFLSimulation(cfg, device="cpu").device.type == "cpu"
    assert build_model(zoo, "cpu").device.type == "cpu"


def test_conv_backward_chunks_keep_the_paper_shapes():
    """The backward's chunk rows at the paper's layers are the 32 KB
    rule's, so dW keeps its summation order: conv1 (1 -> 8, 28 x 28) 256
    rows, conv2 (8 -> 16, 14 x 14) 64, at both dtypes."""
    from repro_torch.kernels.fused_cnn import kernel as knl
    for tsize in (4, 2):
        for need_dx in (False, True):
            assert knl._rows_per_chunk(1, 8, 28, tsize, need_dx) == 256
            assert knl._rows_per_chunk(8, 16, 14, tsize, need_dx) == 64


@pytest.mark.parametrize("wd,c,o,need_dx,rows", [
    (224, 64, 64, False, 8), (64, 64, 32, True, 4), (160, 32, 32, True, 4),
    (224, 64, 64, True, None), (112, 32, 64, True, None)])
def test_conv_backward_chunks_fit_shared_memory(wd, c, o, need_dx, rows):
    """Chunks of the 32 KB rule where they fit (224 x 224, 64 -> 64
    without dx: 8 rows), else halved until a block's shared memory fits
    the limit (the 32 KB rule gives 8 and 16 rows there); a shape whose
    single row does not fit is refused with a message naming the limit."""
    from repro_torch.kernels.fused_cnn import kernel as knl
    if rows is None:
        with pytest.raises(ValueError, match="232320 bytes a block may take"):
            knl._rows_per_chunk(c, o, wd, 4, need_dx)
        return
    assert knl._rows_per_chunk(c, o, wd, 4, need_dx) == rows
    assert knl.conv_bwd_smem(rows, wd, c, o, 4, need_dx) \
        <= knl.CONV_SMEM_LIMIT
    if need_dx:
        assert knl.conv_bwd_smem(2 * rows, wd, c, o, 4, need_dx) \
            > knl.CONV_SMEM_LIMIT


def test_conv_shared_memory_counts():
    """The mirrors of ConvFwdSmem and ConvBwdSmem, counted by hand at the
    paper's layers (f32): conv1's band of 3 pooled rows with residuals,
    conv2's whole image without, conv2's backward chunk of 64 rows with
    dx."""
    from repro_torch.kernels.fused_cnn import kernel as knl
    span = lambda n: (n * 4 + 31) // 16 * 16
    # 8 input rows of 28 x 1, their f32 planes (30 columns), w, b, a,
    # relu_m, eq (6 rows of 28 x 8), pat (6 rows of 28 x 9)
    assert knl.conv_fwd_smem(3, 28, 1, 8, 4, True) == (
        span(8 * 28) + 8 * 30 * 4 + span(72) + span(8) + 2 * span(3 * 14 * 8)
        + span(6 * 28 * 8) + span(6 * 28 * 9))
    assert knl.conv_fwd_smem(7, 14, 8, 16, 4, False) == (
        span(16 * 14 * 8) + 16 * 16 * 8 * 4 + span(72 * 16) + span(16)
        + span(7 * 7 * 16))
    # 64 rows of patches; dz rows with the halo: 64 + 2 * 15 = 94; the
    # pooled rows that cover them: (94 + 13) // 14 // 2 + 2 = 5 (7 wide);
    # the 94 f32 dz rows, their 94 offsets (376 bytes, in whole 16s: 384),
    # w and its f32 copy in rows padded to 20
    n = 64 + 2 * 15
    assert knl.conv_bwd_smem(64, 14, 8, 16, 4, True) == (
        span(64 * 72) + span(n * 16) + 2 * span(5 * 7 * 16) + n * 16 * 4
        + 384 + span(72 * 16) + 72 * 20 * 4)
    with pytest.raises(ValueError, match="232320 bytes a block may take"):
        raise knl._too_big("conv_pool_fwd", 1, "x")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card the smoke exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal path is not taken")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch,
                                                        tmp_path):
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {"fused_cnn", "delta_codec",
                                   "flash_attention", "wkv6", "moe_dispatch"}
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == ROOT / "build" / "kernels"
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert _build.SOURCES[name].is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    # no nvcc on PATH and none under $CUDA_HOME/bin: a clear error
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
