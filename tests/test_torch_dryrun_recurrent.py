"""The dry run's recurrences counted at two short lengths
(``repro_torch.utils.op_stats.recurrence``).

On DTensors the WKV scan and mamba's selective scan run as Python loops
over S; the dry run counts each at lengths 2 and 3 (and 2 + a chunk for
the chunked scan) and extends the counts affinely in S, forward and
backward.  The oracle is the full loop under the same counter: at a short
S the extended FLOPs, HBM bytes and collectives (kind, count, bytes)
equal it exactly, for the whole dry-run program of rwkv6 and hymba
(reduced, on the 2 x 2 x 2 debug mesh of a fake world), and for the scans
alone on plain fake tensors, across a chunk boundary too.  The peak is
an estimate: it is held to the full loop's from above, within 15%.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import mamba, rwkv6  # noqa: E402
from repro_torch.utils.op_stats import ProgramStats  # noqa: E402

B = 32          # splits over pod x data, as the production batch does
PEAK_OVER = 1.15


def _cfg(arch):
    cfg = get_config(arch).reduced()
    return cfg.replace(num_kv_heads=2) if arch == "hymba-1.5b" else cfg


@pytest.mark.parametrize("arch, kind, S", [
    ("rwkv6-7b", "train", 24), ("rwkv6-7b", "prefill", 48),
    ("hymba-1.5b", "train", 24), ("hymba-1.5b", "prefill", 48)])
def test_extended_counts_equal_the_full_loop(arch, kind, S):
    cfg = _cfg(arch)
    shape = InputShape("debug", S, B, kind)
    recs = {}
    with M.fake_world(8):
        mesh = M.make_debug_mesh(device="cpu")
        for full in (True, False):
            recs[full] = D.measure(cfg, shape, mesh, True,
                                   D.make_opts(kind, True), "cpu",
                                   full_loops=full)
    full, ext = recs[True], recs[False]
    assert ext["flops"] == full["flops"] > 0
    assert ext["bytes"] == full["bytes"] > 0
    assert ext["collectives"] == full["collectives"]
    assert sum(v["count"] for v in full["collectives"].values()) > 0
    peak, fpeak = (r["memory"]["peak_memory_in_bytes"] for r in (ext, full))
    assert fpeak <= peak <= PEAK_OVER * fpeak, (peak, fpeak)
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert ext["memory"][key] == full["memory"][key], key


def _wkv_args(S, H=2, D_=8, grad=True):
    ts = [torch.empty(3, S, H, D_, dtype=torch.bfloat16, requires_grad=grad)
          for _ in range(4)]
    return (*ts, torch.empty(H, D_, requires_grad=grad),
            torch.zeros(3, H, D_, D_))


def _scan_args(S, di=16, N=4, grad=True):
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, requires_grad=grad)
    return (torch.bfloat16, t(3, S, di), t(3, S, N), t(3, S, N), t(3, S, di),
            t(di, N), t(di), t(3, S, di, dtype=torch.bfloat16))


def _count(fn, args, extrapolate):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = args()
        with ProgramStats(hold=args, extrapolate=extrapolate) as st:
            out = fn(*args)
            y = out[0] if isinstance(out, tuple) else out
            leaves = [a for a in args if isinstance(a, torch.Tensor)
                      and a.requires_grad]
            if leaves:
                torch.autograd.grad(y, leaves, torch.ones_like(y),
                                    allow_unused=True)
    return st.record()


@pytest.mark.parametrize("name, S", [
    ("wkv", 40), ("scan", 40), ("scan", mamba.SCAN_CHUNK + 5),
    ("scan", 2 * mamba.SCAN_CHUNK), ("scan-forward", mamba.SCAN_CHUNK + 9)])
def test_the_scans_alone_extend_exactly(name, S):
    """Plain fake tensors, forward and backward; the chunked scan across
    one and two chunk boundaries."""
    if name == "wkv":
        fn, args = rwkv6.WKV_SCAN, functools.partial(_wkv_args, S)
    else:
        fn = mamba.GATED_SCAN
        args = functools.partial(_scan_args, S, grad=name == "scan")
    full, ext = _count(fn, args, False), _count(fn, args, True)
    assert ext["flops"] == full["flops"] > 0
    assert ext["bytes"] == full["bytes"] > 0
    peak, fpeak = (r["memory"]["peak_memory_in_bytes"] for r in (ext, full))
    assert fpeak <= peak <= PEAK_OVER * fpeak, (peak, fpeak)


def test_outside_the_dry_run_a_recurrence_is_its_function():
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(2, 9, 2, 8, generator=gen) for _ in range(3))
    w = torch.rand(2, 9, 2, 8, generator=gen)
    u = torch.randn(2, 8, generator=gen)
    s0 = torch.zeros(2, 2, 8, 8)
    got = rwkv6.WKV_SCAN(r, k, v, w, u, s0)
    want = rwkv6.wkv_scan(r, k, v, w, u, s0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # under a counter that does not extrapolate, too
    with ProgramStats():
        again = rwkv6.WKV_SCAN(r, k, v, w, u, s0)
    assert all(torch.equal(a, b) for a, b in zip(again, want))
