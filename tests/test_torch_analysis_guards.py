"""repro_torch.analysis.guards on the CPU: launch budgets, the transfer
guard's logic, transform-leak checks and memory budgets around the port's
rounds.

The CPU has no card: a host-to-device copy cannot even be attempted here
(CPU-only torch raises "Torch not compiled with CUDA enabled" before any
mode sees it), so the copy guard's logic is driven with the ``meta``
device standing in for the card; the card tests
(``tests/test_torch_kernels_cuda.py``) drive it on CUDA.  The kernel
wrappers count no launch on CPU tensors, so the launch counter is driven
through a wrapper whose plain twin is patched to count as the kernel would.
"""
import pytest
import torch

from repro_torch.analysis import contracts as tc
from repro_torch.analysis import guards as g
from repro_torch.kernels import _build
from repro_torch.kernels.delta_codec import kernel as dck


def _device_round(scheme="opt", **extra):
    from repro_torch.core.channel_lib import ChannelParams
    from repro_torch.core.fused_round import build_device_round
    fn = build_device_round(
        scheme=scheme, local_epochs=2, steps_per_epoch=1, batch_size=4,
        lr=0.01, k_select=4, channel=ChannelParams(), model_bytes=1e6,
        ue_model_fraction=0.25, **extra)
    return fn, tc.device_round_inputs("cpu")


def _fused_round():
    from repro_torch.core.fused_round import build_fused_round
    fn = build_fused_round(scheme="opt", local_epochs=2, steps_per_epoch=1,
                           lr=0.01, tau_max=9.0, probe_epochs=(1,))
    return fn, tc.fused_round_inputs("cpu")


# ---------------------------------------------------------------------------
# leak_check
# ---------------------------------------------------------------------------

def test_leak_check_catches_a_tensor_leaked_from_vmap():
    leaked = []

    def per_row(x):
        leaked.append(x * 2.0)
        return x.sum()

    with pytest.raises(g.TransformLeak, match="outlived"):
        with g.leak_check():
            torch.func.vmap(per_row)(torch.ones(3, 4))
    assert torch._C._functorch.is_functorch_wrapped_tensor(leaked[0])


def test_leak_check_catches_a_tensor_leaked_from_grad():
    leaked = []

    def loss(w):
        leaked.append(w * 3.0)
        return (w ** 2).sum()

    with pytest.raises(g.TransformLeak):
        with g.leak_check():
            torch.func.grad(loss)(torch.ones(4))


def test_leak_check_ignores_leaks_from_before_the_block():
    leaked = []
    torch.func.vmap(lambda x: (leaked.append(x + 1), x)[1])(torch.ones(2, 2))
    with g.leak_check():
        torch.func.vmap(lambda x: x * 2)(torch.ones(2, 2))


@pytest.mark.parametrize("scheme,extra", [
    ("opt", {}), ("async", {}), ("opt", {"use_codec": True})],
    ids=["opt", "async", "opt-codec"])
def test_device_round_passes_leak_check_and_engine_guard(scheme, extra):
    """The device round aggregates under ``torch.func.vmap``: nothing of
    it may outlive the round, and on the CPU it launches nothing and
    copies nothing onto a card."""
    fn, (carry, stream, sim, cfg) = _device_round(scheme, **extra)
    with g.engine_guard(budget=0) as lc:
        for t in (1, 2):
            carry, metrics = fn(carry, t, stream, sim, cfg)
    assert lc.count() == 0 and lc.builds == []
    assert metrics.selected.shape == (2,)
    assert bool(torch.isfinite(metrics.test_loss).all())


# ---------------------------------------------------------------------------
# memory_budget
# ---------------------------------------------------------------------------

def _fused_peak(limit):
    fn, (params, xs, ys, chan) = _fused_round()
    with g.memory_budget(limit, device="cpu") as records:
        fn(params, xs, ys, chan)
    return records


def test_memory_budget_holds_the_fused_round_at_its_limit():
    (label, peak), = _fused_peak(2 ** 40)
    assert label == "cpu peak" and peak > 0
    # the peak is a property of the round's ops: again exactly the same
    assert _fused_peak(peak) == [("cpu peak", peak)]
    with pytest.raises(g.MemoryBudgetExceeded, match=f"of {peak} bytes"):
        _fused_peak(peak - 1)


def test_memory_budget_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with g.memory_budget(2 ** 30):
            pass


# ---------------------------------------------------------------------------
# launch_budget / LaunchCounter
# ---------------------------------------------------------------------------

@pytest.fixture
def counting_codec(monkeypatch):
    """The codec wrappers' CPU twins, patched to count a launch each as
    the CUDA path does."""
    for fn, counter in (("quantize_ref", "quantize_blocks"),
                        ("dequantize_ref", "dequantize_blocks")):
        orig = getattr(dck.ref, fn)

        def counted(*a, orig=orig, counter=counter, **kw):
            dck.LAUNCHES[counter] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(dck.ref, fn, counted)
    yield
    dck.reset_launches()


def test_launch_counter_diffs_the_wrappers_counts(counting_codec):
    x = torch.randn(8, 512, generator=torch.Generator().manual_seed(0))
    dck.quantize_blocks(x)                       # before the block
    with g.LaunchCounter() as lc:
        for _ in range(3):
            q, s = dck.quantize_blocks(x)
        dck.dequantize_blocks(q, s)
        assert lc.count() == 4                  # live inside the block
    dck.quantize_blocks(x)                       # after it
    assert lc.launches() == {"quantize_blocks": 3, "dequantize_blocks": 1}
    assert lc.count(match="^quantize") == 3 and lc.builds == []
    with g.launch_budget(4) as lc2:
        for _ in range(4):
            dck.quantize_blocks(x)
    assert lc2.count() == 4 and lc2.bf16_launches() == {}


def test_launch_counter_reads_the_bf16_counts(monkeypatch):
    from repro_torch.kernels.fused_cnn import kernel as fk
    monkeypatch.setitem(fk.LAUNCHES, "fc_chain_fwd_k", 5)
    monkeypatch.setitem(fk.LAUNCHES_BF16, "fc_chain_fwd_k", 1)
    with g.LaunchCounter() as lc:
        fk.LAUNCHES["fc_chain_fwd_k"] += 3          # 3 launches, 2 of bf16
        fk.LAUNCHES_BF16["fc_chain_fwd_k"] += 2
    assert lc.launches() == {"fc_chain_fwd_k": 3}
    assert lc.bf16_launches() == {"fc_chain_fwd_k": 2}


def test_launch_budget_overrun_names_the_wrappers(counting_codec):
    x = torch.randn(8, 512, generator=torch.Generator().manual_seed(0))
    with pytest.raises(g.LaunchBudgetExceeded,
                       match=r"3 launches, budget is 2; by wrapper: "
                             r"\{'quantize_blocks': 3\}"):
        with g.launch_budget(2):
            for _ in range(3):
                dck.quantize_blocks(x)
    with pytest.raises(g.LaunchBudgetExceeded, match="matching 'deq'"):
        with g.engine_guard(budget=0, match="deq"):
            q, s = dck.quantize_blocks(x)
            dck.dequantize_blocks(q, s)
    with g.launch_budget(0, match="deq"):
        dck.quantize_blocks(x)


def test_launch_budget_refuses_a_library_build(monkeypatch):
    monkeypatch.setattr(_build, "build_all",
                        lambda names=None: {n: 1.0 for n in names or ()})
    with pytest.raises(g.LaunchBudgetExceeded, match=r"built \['wkv6'\]"):
        with g.launch_budget(10):
            _build.build_all(["wkv6"])
    # the patch is undone on exit, and an empty build counts nothing
    with g.launch_budget(10) as lc:
        _build.build_all([])
    assert lc.builds == []
    assert _build.build_all.__name__ == "<lambda>"


def test_kernel_modules_are_every_kernel_package():
    names = {m.__name__ for m in g.kernel_modules()}
    assert names == {f"repro_torch.kernels.{p}.kernel" for p in
                     ("delta_codec", "flash_attention", "fused_cnn",
                      "moe_dispatch", "wkv6")}


# ---------------------------------------------------------------------------
# no_implicit_transfers
# ---------------------------------------------------------------------------

def test_unknown_direction_raises_value_error():
    with pytest.raises(ValueError, match="sideways"):
        with g.no_implicit_transfers("sideways"):
            pass


def test_copy_guard_catches_host_copies_onto_the_target():
    """The host-to-device logic with ``meta`` standing in for the card."""
    with g._host_to_device("meta"):
        with pytest.raises(g.ImplicitTransfer, match="_to_copy"):
            torch.ones(4).to("meta")
        with pytest.raises(g.ImplicitTransfer, match="copy_"):
            torch.empty(4, device="meta").copy_(torch.ones(4))
        with pytest.raises(g.ImplicitTransfer, match="tensor"):
            torch.tensor([1.0, 2.0], device="meta")
        with pytest.raises(g.ImplicitTransfer, match="as_tensor"):
            torch.as_tensor([1.0], device="meta")
        # staged data, host-only work and casts on the target are legal
        staged = torch.empty(4, device="meta")
        staged + 1
        torch.ones(4).to(torch.float64)
        torch.tensor([1.0])
        staged.to(torch.bfloat16)


@pytest.mark.parametrize("direction",
                         ["host_to_device", "device_to_host", "all"])
def test_host_only_round_is_clean_in_every_direction(direction):
    fn, (params, xs, ys, chan) = _fused_round()
    with g.no_implicit_transfers(direction):
        _, stats = fn(params, xs, ys, chan)
    assert stats.arrived.shape == (4,)
