"""The CUDA kernels (fused CNN, delta codec, flash attention, WKV6) against
their plain twins on the card, and the port's import hygiene.

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

The zoo's kernels are held to their twins at Llama-3.2-1B's and
RWKV6-7B's prefill shapes, on masks, ragged lengths, Sq < Sk and every
head size, within 1e-5 of the largest magnitude at f32 and one bf16 ulp
(2**-7) at bf16; a reduced prefill must launch one kernel per layer, and
the card's forward must match the CPU twins (logits, and greedy tokens at
f32).  The flash kernels, WKV6 and the fc forward and backward give the
same bits on every run; WKV6 runs at every head dim it is built for and
flash attention past 65 535 rows of B·H.

The hygiene tests run everywhere: the port imports neither JAX, nor the
JAX package, nor ``msgpack`` (absent on the card's machine), and an entry
point given no device refuses to run without a card.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

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


COHORTS = [(10, 10, False), (3, 7, False), (3, 2, True)]
IDS = ["main-K10-B10", "odd-K3-B7", "ones-tie-K3-B2"]


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
    (2, 3, 6, 1, 8, True), (2, 3, 6, 3, 5, True)]


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
            "serving", "training"} <= walked
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
            "repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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
                                   "flash_attention", "wkv6"}
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
