"""The K-parameterized engine-program registry the IR auditors sweep
(``repro/analysis/ir/programs.py``).

One place answers "what programs does the port ship?", so the graph
walker and the K-scaling gate audit the same list, and the coverage tests
can assert that every registered scheme appears through *both* round
builders and that every ``kernels/*`` ref/kernel twin package has an IR
entry (the contract sweep in ``analysis/contracts.py`` makes the same
promise for signatures).

Every entry is an ``EngineProgram`` whose ``build(K)`` returns
``(fn, args)``: ``args`` are CPU tensors drawn from a seeded
``torch.Generator``.  The reference's arguments are abstract
(``ShapeDtypeStruct``s) and its Pallas kernels run their bodies in
interpret mode; the port's kernel wrappers refuse fake tensors
(``kernels/_build.on_cpu``), so the programs are traced in ``make_fx``'s
real mode on CPU tensors, where every wrapper takes its CPU branch and a
kernel's work shows up as its plain twin's aten ops.  ``K`` scales the
user/cohort axis (and only that axis), which is what lets the scaling
gate fit per-buffer exponents in K.  Outside K the sizes are the
reference's: at K = 256 the largest program holds about 1 GB.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

# tiny-but-representative non-K dims (the reference's, as in
# analysis/contracts.py)
_E, _STEPS, _BS = 2, 1, 4
_XDIM = (28, 28, 1)
_M = 32          # samples per client (device-round gather source)
_NTEST = 16
_SEED = 0

FUSED_PATH = "src/repro_torch/core/fused_round.py"
KERNELS_PATH = "src/repro_torch/kernels"
KERNEL_PACKAGES = ("fused_cnn", "delta_codec", "flash_attention", "wkv6",
                   "moe_dispatch")


@dataclasses.dataclass(frozen=True)
class EngineProgram:
    """One auditable program.  ``build(K) -> (fn, args)``.

    ``family`` groups findings ("fused_round" / "device_round" /
    "kernel"); ``path`` anchors program-level findings that have no
    better source site; ``compute_dtype`` declares the compute policy the
    dtype audit enforces ("bf16" programs may not mint f32 tensors from
    bf16 operands outside a visible cast).  ``scheme``/``twin`` tag
    coverage.  The reference's ``donate_argnums`` has no counterpart: the
    port donates nothing (its engines update their carries in place)."""
    name: str
    family: str
    path: str
    build: Callable[[int], Tuple[Callable, Tuple[Any, ...]]]
    compute_dtype: str = "f32"
    scheme: str = ""
    twin: str = ""


class _Draw:
    """Seeded CPU tensors: normal floats, ints in [0, hi), bools."""

    def __init__(self, seed: int = _SEED):
        self.gen = torch.Generator().manual_seed(seed)

    def normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen)

    def uniform(self, *shape, lo: float = 0.0, hi: float = 1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen)

    def ints(self, hi: int, *shape) -> torch.Tensor:
        return torch.randint(0, hi, shape, generator=self.gen)

    def bools(self, p: float, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen) < p


def _params():
    from repro_torch.models.cnn import init_cnn
    return init_cnn(_SEED, "cpu")


def _stack(tree, k: int):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.unsqueeze(0).repeat((k,) + (1,) * t.dim())
                    .contiguous(), tree)


# ---------------------------------------------------------------------------
# round builders
# ---------------------------------------------------------------------------

def _fused_args(k: int, carries_delayed: bool):
    d = _Draw()
    params = _params()
    xs = d.normal(_E, k, _STEPS, _BS, *_XDIM)
    ys = d.ints(10, _E, k, _STEPS, _BS)
    chan = {
        "rates": d.uniform(_E, k, lo=1e6, hi=2e7),
        "outages": d.bools(0.3, _E, k),
        "payload_bits": torch.full((k,), 8e6),
        "tau_extra0": d.uniform(k, hi=2.0),
        "final_rate": d.uniform(k, lo=1e6, hi=2e7),
        "train_time": d.uniform(k, lo=1.0, hi=4.0),
        "final_outage": d.bools(0.3, k),
        "valid": torch.ones(k, dtype=torch.bool),
    }
    if carries_delayed:
        return (params, _stack(params, k), d.bools(0.5, k), xs, ys, chan)
    return (params, xs, ys, chan)


def _build_fused(scheme_name: str, forward=None):
    from repro_torch.core.fused_round import build_fused_round
    from repro_torch.core.schemes import get_scheme

    def build(k: int):
        scheme = get_scheme(scheme_name)
        probe = scheme.static_schedule(_E, 2)
        kw: Dict[str, Any] = dict(
            scheme=scheme_name, local_epochs=_E, steps_per_epoch=_STEPS,
            lr=0.01, tau_max=9.0, probe_epochs=probe, forward=forward)
        if scheme.carries_delayed:
            fn = build_fused_round(k_carry=k, async_weight=0.283, **kw)
        else:
            fn = build_fused_round(**kw)
        return fn, _fused_args(k, scheme.carries_delayed)

    return build


def _device_args(k: int):
    """A group of one simulation under one config, N = K UAVs."""
    from repro_torch.core.channel_lib import ChannelParams, fleet_init
    from repro_torch.core.fused_round import DeviceSimCarry
    from repro_torch.core.streams import GroupStream, TorchStream

    d = _Draw()
    stream = GroupStream([TorchStream(_SEED, "cpu")])
    params = _stack(_params(), 1)
    fleet = fleet_init(stream.fleet_init_draws(k, ChannelParams()),
                       ChannelParams())
    carry = DeviceSimCarry(
        params=params, fleet=fleet, delayed=_stack(_stack(_params(), k), 1),
        delayed_mask=torch.zeros((1, k), dtype=torch.bool))
    sim = {
        "client_x": d.normal(1, k, _M, *_XDIM),
        "client_y": d.ints(10, 1, k, _M),
        "client_len": torch.full((1, k), _M, dtype=torch.int64),
        "flops": torch.full((1, k), 1e9),
        "samples": torch.full((1, k), float(_M)),
        "test_x": d.normal(1, _NTEST, *_XDIM),
        "test_y": d.ints(10, 1, _NTEST),
    }
    cfg = {"b": torch.tensor([2.0]), "tau_max": torch.tensor([9.0]),
           "bandwidth_ratio": torch.tensor([1.0])}
    return stream, (carry, sim, cfg)


def _build_device(scheme_name: str, forward=None, use_codec: bool = False):
    from repro_torch.core.channel_lib import ChannelParams
    from repro_torch.core.fused_round import build_device_round

    def build(k: int):
        # N = K (every UAV selected): buffers on the fleet axis and on the
        # selected-cohort axis scale together, as in the reference
        round_fn = build_device_round(
            scheme=scheme_name, local_epochs=_E, steps_per_epoch=_STEPS,
            batch_size=_BS, lr=0.01, k_select=k, channel=ChannelParams(),
            model_bytes=1e6, ue_model_fraction=0.25, use_codec=use_codec,
            compress_ratio=0.252 if use_codec else 1.0, forward=forward)
        stream, args = _device_args(k)

        def fn(carry, sim, cfg):
            return round_fn(carry, 1, stream, sim, cfg)

        return fn, args

    return build


# ---------------------------------------------------------------------------
# kernel twins (K scales the stacked-cohort / batch axis)
# ---------------------------------------------------------------------------

def _build_kernel(pkg: str, variant: str = ""):
    def build(k: int):
        d = _Draw()
        if pkg == "fused_cnn":
            from repro_torch.kernels.fused_cnn.ops import (
                ForwardPolicy, make_stacked_loss_grad)
            pol = ForwardPolicy(precision="bf16" if variant == "bf16"
                                else "f32")
            return make_stacked_loss_grad(pol), (
                _stack(_params(), k), d.normal(k, _BS, *_XDIM),
                d.ints(10, k, _BS))
        if pkg == "delta_codec":
            from repro_torch.kernels.delta_codec.kernel import quantize_blocks
            return quantize_blocks, (d.normal(k * 8, 512),)
        if pkg == "flash_attention":
            from repro_torch.kernels.flash_attention.kernel import \
                flash_attention_bh

            def attend(q, kk, v):
                return flash_attention_bh(q, kk, v, causal=True)

            return attend, tuple(d.normal(k, 128, 64) for _ in range(3))
        if pkg == "wkv6":
            from repro_torch.kernels.wkv6.ops import wkv6
            r, kk, v = (d.normal(k, 64, 2, 64) for _ in range(3))
            w = d.uniform(k, 64, 2, 64, lo=0.5, hi=0.99)
            return wkv6, (r, kk, v, w, d.normal(2, 64))
        if pkg == "moe_dispatch":
            from repro_torch.kernels.moe_dispatch import (moe_combine,
                                                          moe_scatter,
                                                          moe_slots)
            # 16·K tokens, top-2 of 4 experts, capacity factor 1.25
            T, top, E = 16 * k, 2, 4
            C = 5 * T * top // (4 * E)

            def moe(x, flat_e, flat_w):
                slot, _, counts = moe_slots(flat_e, E, C)
                buf = moe_scatter(x, slot, counts, E, C, top)
                return moe_combine(buf, slot, flat_w, top)

            return moe, (d.normal(T, 64), d.ints(E, T * top),
                         d.uniform(T * top))
        raise ValueError(f"no IR program for kernels/{pkg}")

    return build


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def engine_programs() -> List[EngineProgram]:
    """Every program the IR sweep audits.

    The scheme list comes from the live registry, so a newly registered
    scheme enters the IR sweep automatically (coverage-asserted in
    ``tests/test_torch_analysis_ir.py``); the kernel list is asserted
    against the ``kernels/*`` twin packages on disk the same way."""
    from repro_torch.core.schemes import registered_schemes
    from repro_torch.kernels.fused_cnn.ops import ForwardPolicy

    progs: List[EngineProgram] = []
    for name in registered_schemes():
        progs.append(EngineProgram(
            name=f"fused_round[{name}]", family="fused_round",
            path=FUSED_PATH, build=_build_fused(name), scheme=name))
        progs.append(EngineProgram(
            name=f"device_round[{name}]", family="device_round",
            path=FUSED_PATH, build=_build_device(name), scheme=name))
    progs.append(EngineProgram(
        name="fused_round[opt+bf16]", family="fused_round", path=FUSED_PATH,
        build=_build_fused("opt", forward=ForwardPolicy(precision="bf16")),
        compute_dtype="bf16", scheme="opt"))
    progs.append(EngineProgram(
        name="device_round[opt+codec]", family="device_round",
        path=FUSED_PATH, build=_build_device("opt", use_codec=True),
        scheme="opt"))
    for pkg in KERNEL_PACKAGES:
        progs.append(EngineProgram(
            name=f"kernel[{pkg}]", family="kernel",
            path=f"{KERNELS_PATH}/{pkg}/kernel.py",
            build=_build_kernel(pkg), twin=pkg))
    progs.append(EngineProgram(
        name="kernel[fused_cnn+bf16]", family="kernel",
        path=f"{KERNELS_PATH}/fused_cnn/kernel.py",
        build=_build_kernel("fused_cnn", "bf16"), compute_dtype="bf16",
        twin="fused_cnn"))
    return progs


def program_names() -> List[str]:
    return [p.name for p in engine_programs()]


def covered_schemes() -> Dict[str, set]:
    """family -> set of scheme names with an IR entry (coverage asserts)."""
    out: Dict[str, set] = {"fused_round": set(), "device_round": set()}
    for p in engine_programs():
        if p.scheme and p.family in out:
            out[p.family].add(p.scheme)
    return out


def covered_kernel_twins() -> set:
    return {p.twin for p in engine_programs() if p.twin}
