"""The work counts and peaks, pinned to numbers worked by hand, and
cross-checked once against the port's own FLOP counter."""
import json

import pytest
import torch

from perfbench import harness

PB = harness.HERE


def _cfg(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def _work(name):
    return harness.load_module(PB / "work" / f"{name}.py")


def test_cnn_forward_is_782848_flops_an_image():
    # conv1 28·28·9·1·8 + conv2 14·14·9·8·16 + fc 784·128 + 128·64 + 64·10
    # multiply-adds = 391 424, two FLOPs each
    assert _work("paper-cnn").forward_flops_per_image(_cfg("paper-cnn")) \
        == 782848


def test_cnn_train_step_and_row_round():
    w, cfg = _work("paper-cnn"), _cfg("paper-cnn")
    # backward: every weight gradient (the forward's 391 424 MACs) and
    # every input gradient but conv1's (391 424 - 56 448)
    assert w.train_flops_per_image(cfg) == 782848 + 2 * (391424 + 334976)
    # 10 users x 6 epochs x 4 steps x 10 images, and 1000 test images
    assert w.row_round_flops(cfg, 2) == 2 * (2400 * 2235648 + 1000 * 782848)


def test_cnn_kernel_launches_per_group_round():
    launches = _work("paper-cnn").launch_work(_cfg("paper-cnn"), 48)
    # 24 steps x (2 conv fwd, 2 conv bwd, 1 fc fwd, 1 fc bwd) + the eval's
    # 2 conv fwd and 1 fc fwd: 147
    assert {k: len(v) for k, v in launches.items()} == {
        "conv_pool_fwd_k": 50, "conv_pool_bwd_k": 48, "fc_chain_fwd_k": 25,
        "fc_chain_bwd_k": 24}
    # conv1's forward over 480 users x 10 images: images in, pooled out
    fl, nb = launches["conv_pool_fwd_k"][0]
    assert fl == 2.0 * 4800 * 28 * 28 * 9 * 8
    assert nb == 4 * (4800 * 784 + 480 * 80 + 4800 * 14 * 14 * 8)


def test_granite_active_params_are_807m_a_token():
    w, cfg = _work("granite-moe-3b-a800m"), _cfg("granite-moe-3b-a800m")
    attn = 2 * 1536 * 1536 + 2 * 1536 * 512
    layer = attn + 1536 * 40 + 8 * 3 * 1536 * 512
    assert w.layer_active_params(cfg) == layer == 25227264
    assert 32 * layer == 807272448
    assert w.active_params(cfg) == 807272448 + 1536 * 49155
    # causal attention of one layer over 2 sequences of 4
    assert w.attention_flops(cfg, 2, 4) == 2 * 2 * 24 * 64 * 2 * 10


def test_flash_bound_is_bytes_at_chat_lengths():
    w, cfg = _work("granite-moe-3b-a800m"), _cfg("granite-moe-3b-a800m")
    peaks = harness.device_peaks(harness.load_json(PB / "peaks.json"),
                                 "NVIDIA H100 80GB HBM3")
    nbytes = 2 * 42 * 384 * 64 * (2 * 24 + 2 * 8)
    assert w.flash_bound_s(cfg, 42, 384, peaks) == pytest.approx(
        32 * nbytes / 3.35e12)


def test_peaks_table():
    peaks = harness.load_json(PB / "peaks.json")
    h100 = harness.device_peaks(peaks, "NVIDIA H100 80GB HBM3")
    assert h100["f32_flops_per_s"] == 67e12
    assert h100["bf16_flops_per_s"] == 989e12
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert harness.device_peaks(peaks, "cpu") == {}


def test_counts_agree_with_the_ports_flop_counter():
    """The CNN's forward, and a granite forward cut to test size with every
    expert active (so the dense dispatch does exactly the active work),
    under ``utils/op_stats.ProgramStats``.  The port's counter sees the
    padded vocabulary (512 rows for 300) and the CPU twin's full score
    matrix where the work counts take the real vocabulary and the causal
    half."""
    from repro_torch.models import cnn
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import abstract_init
    from repro_torch.utils.op_stats import ProgramStats

    from perfbench import inputs, testing
    from perfbench.drivers import prefill
    w, cfg = _work("paper-cnn"), _cfg("paper-cnn")
    with ProgramStats() as stats:
        cnn.forward_im2col(cnn.init_cnn(0, "cpu"), torch.zeros(3, 28, 28, 1))
    assert stats.flops == 3 * w.forward_flops_per_image(cfg)

    g = {**_cfg("granite-moe-3b-a800m"), **testing.TINY_GRANITE}
    g["num_experts_per_tok"] = g["num_local_experts"]
    mcfg = prefill.model_config(g)
    params = inputs.zoo_weights(1, prefill.weight_leaves(abstract_init(mcfg)),
                                "cpu")
    b, s = 2, 16
    with ProgramStats() as stats:
        tf.forward_full(params, mcfg, {"tokens": torch.zeros(b, s).long()},
                        {"moe_dispatch": "dense"})
    gw = _work("granite-moe-3b-a800m")
    layers, d = g["num_hidden_layers"], g["hidden_size"]
    assert gw.active_params(g) == layers * gw.layer_active_params(g) \
        + d * 300
    want = (2 * b * s * (layers * gw.layer_active_params(g)
                         + d * mcfg.vocab_padded)
            + layers * 2 * 2 * 4 * 16 * b * s * s)
    assert stats.flops == want
    assert gw.batch_flops(g, b, s) == 2 * b * s * gw.active_params(g) \
        + layers * gw.attention_flops(g, b, s)
