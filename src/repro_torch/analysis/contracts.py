"""Shape/dtype contracts of the port's entry points
(``repro/analysis/contracts.py``).

The reference proves its signatures with ``jax.eval_shape``: every program
is traced, never executed.  The port's abstract evaluation is
``torch._subclasses.fake_tensor.FakeTensorMode`` (``abstract``): plain
torch runs on fake tensors that carry a shape, a dtype and a device and
no data.  The kernel wrappers cannot run there: they read and write
through raw pointers, and ``kernels/_build.on_cpu`` refuses every tensor
subclass, the fake tensor included.  So whatever goes through a wrapper
runs for real (``concrete``) at the same tiny sizes, on the contract's
device: on the card the CUDA kernels launch, on the CPU the wrappers run
their plain twins.  That is

- both round contracts (1 and 2): every epoch of a round trains through
  the fused-CNN wrappers, the codec variants quantize through the codec's,
  and the eval runs the forward kernels.  They run on real tensors of the
  sizes below (``_N, _K, _E, _STEPS, _BS``, 28x28x1 images), their data
  drawn from a seeded generator;
- the kernel side of every twin (contract 3); its reference side, plain
  torch, runs on fake tensors.

Checked contracts:

1. **Device round carry stability** — for every registered scheme, and
   for the codec and kernel-policy variants, ``build_device_round``'s
   round function must return a ``DeviceSimCarry`` identical in shape and
   dtype to its input (the sweep chains it round after round; any drift
   breaks the next round), and every ``DeviceRoundMetrics`` field keeps its
   declared dtype.  Unlike the reference's round, which ``vmap``s over one
   row and takes a key, the port's folds the group's G = S·C (simulation,
   config) rows onto a leading axis and takes ``(carry, round_t, stream,
   sim, cfg)``: here S = 1 simulation under C = 2 configs, so every carry
   leaf and metric has a leading G = 2 (the fleet a leading S = 1).
2. **Fused round params preservation** — for every registered scheme,
   ``build_fused_round`` must return ``new_params`` with exactly the input
   params' shapes and dtypes (the host engine chains rounds through the
   same buffers, updated in place), ``RoundStats`` stays ``(K,)``
   bool/int32, and the async straggler carry keeps its fixed width.
3. **Kernel twin equivalence** — every ``kernels/*`` package with a
   ``ref.py``/``kernel.py`` pair must appear in the twin registry below,
   and each twin pair must produce identical signatures on
   representative inputs (the value-level pins live in the tests and in
   ``chip_smoke.py``).
4. **Scheme program identity** — ``lowered_program`` of every scheme
   resolves to a registered scheme for representative budget pins.

``run_contracts(repo_root, device=None)``, ``check_device_round``,
``check_fused_round`` and ``check_kernel_twins`` follow the port's device
rule (``repro_torch.device``): ``None`` is the CUDA card, and without one
they raise.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.device import resolve_device

_SCHEMES_PATH = "src/repro_torch/core/schemes.py"
_FUSED_PATH = "src/repro_torch/core/fused_round.py"
_KERNELS = "src/repro_torch/kernels"

# tiny-but-representative example scale (the reference's)
_N, _K, _E, _STEPS, _BS = 8, 4, 2, 1, 4
# the device round's group: S simulations x C configs, G = S·C rows
_S, _C = 1, 2
_IMG = (28, 28, 1)
_SEED = 0


class Spec(NamedTuple):
    """A tensor's shape and dtype: the port's ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensor and ``Spec`` leaves of a tree of dicts,
    NamedTuples, tuples and lists (dict keys in sorted order)."""
    if isinstance(tree, (torch.Tensor, Spec)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return tree


def spec_tree(tree: Any) -> Any:
    """Every tensor of ``tree`` as its ``Spec``."""
    return _map(lambda t: Spec(tuple(t.shape), t.dtype), tree)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _map(out.append, tree)
    return out


def _treedef(tree: Any) -> str:
    """The tree's structure, every leaf printed as ``*``."""
    if isinstance(tree, (torch.Tensor, Spec)):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_treedef(t)}" for f, t in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_treedef(t) for t in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    return repr(tree)


def dtype_name(dtype: torch.dtype) -> str:
    """``float32`` for ``torch.float32``: the name numpy and JAX print."""
    return str(dtype).removeprefix("torch.")


def _sig(tree: Any) -> List[str]:
    """Canonical printable signature of a tree of tensors or specs."""
    tree = spec_tree(tree)
    out = [f"treedef={_treedef(tree)}"]
    out += [f"{i}: {tuple(s.shape)} {dtype_name(s.dtype)}"
            for i, s in enumerate(_leaves(tree))]
    return out


def diff_signatures(a: Any, b: Any) -> List[str]:
    """Human-readable differences between two spec trees ([] if equal)."""
    sa, sb = _sig(a), _sig(b)
    return [f"{x} != {y}" for x, y in zip(sa, sb) if x != y] \
        + [f"arity {len(sa)} != {len(sb)}"] * (len(sa) != len(sb))


# ---------------------------------------------------------------------------
# the two evaluators
# ---------------------------------------------------------------------------

def abstract(fn: Callable, *specs: Any, device="cpu") -> Any:
    """``fn``'s output specs on fake tensors of ``specs`` (trees of
    ``Spec``) on ``device``: shapes and dtypes only, nothing computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = [_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device=device), s) for s in specs]
        return spec_tree(fn(*args))


def _real(spec: Spec, gen: torch.Generator, device) -> torch.Tensor:
    """Seeded data of ``spec``: normal floats, ints in [0, 10), fair
    bools (drawn on the CPU, copied to ``device``)."""
    if spec.dtype.is_floating_point:
        t = torch.randn(spec.shape, generator=gen).to(spec.dtype)
    elif spec.dtype == torch.bool:
        t = torch.rand(spec.shape, generator=gen) < 0.5
    else:
        t = torch.randint(0, 10, spec.shape, generator=gen, dtype=spec.dtype)
    return t.to(device)


def concrete(fn: Callable, *specs: Any, device="cpu") -> Any:
    """``fn``'s output specs on real seeded tensors of ``specs`` on
    ``device``: what runs through a kernel wrapper (see the module's
    docstring)."""
    gen = torch.Generator().manual_seed(_SEED)
    args = [_map(lambda s: _real(s, gen, device), s) for s in specs]
    with torch.no_grad():
        return spec_tree(fn(*args))


# ---------------------------------------------------------------------------
# scheme round contracts
# ---------------------------------------------------------------------------

def _example_params(device) -> dict:
    from repro_torch.models.cnn import init_cnn
    return init_cnn(_SEED, device)


def _stack(tree: Any, n: int) -> Any:
    return _map(lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.dim())
                .contiguous(), tree)


def device_round_inputs(device) -> Tuple[Any, Any, Dict, Dict]:
    """``(carry, stream, sim, cfg)`` of the device round's contract: a
    group of S simulations under C configs at the tiny sizes."""
    from repro_torch.core.channel_lib import ChannelParams, fleet_init
    from repro_torch.core.fused_round import DeviceSimCarry
    from repro_torch.core.streams import GroupStream, TorchStream

    g = _S * _C
    params = _stack(_example_params(device), g)
    stream = GroupStream([TorchStream(s, device) for s in range(_S)])
    fleet = fleet_init(stream.fleet_init_draws(_N, ChannelParams()),
                       ChannelParams())
    carry = DeviceSimCarry(
        params=params, fleet=fleet,
        delayed=_map(lambda t: torch.zeros((g, _K) + tuple(t.shape[1:]),
                                           device=device), params),
        delayed_mask=torch.zeros((g, _K), dtype=torch.bool, device=device))
    gen = torch.Generator().manual_seed(_SEED)
    sim = {
        "client_x": _real(Spec((_S, _N, 32) + _IMG, torch.float32), gen,
                          device),
        "client_y": _real(Spec((_S, _N, 32), torch.int64), gen, device),
        "client_len": torch.full((_S, _N), 32, dtype=torch.int64,
                                 device=device),
        "flops": torch.full((_S, _N), 1e9, device=device),
        "samples": torch.full((_S, _N), 32.0, device=device),
        "test_x": _real(Spec((_S, 16) + _IMG, torch.float32), gen, device),
        "test_y": _real(Spec((_S, 16), torch.int64), gen, device),
    }
    cfg = {"b": torch.tensor([1.0, 2.0][:_C], device=device),
           "tau_max": torch.full((_C,), 9.0, device=device),
           "bandwidth_ratio": torch.ones(_C, device=device)}
    return carry, stream, sim, cfg


DEVICE_METRIC_DTYPES = {
    "selected": torch.int32, "arrived": torch.int32, "rescued": torch.int32,
    "delayed": torch.int32, "dropped": torch.int32,
    "bytes_sent": torch.float32, "test_loss": torch.float32,
    "test_acc": torch.float32}


def device_round_variants(schemes=None) -> List[Tuple[str, str, Dict]]:
    """``(label, scheme, extra build kwargs)``: every registered scheme,
    then opt with the codec and opt under the kernel policy (the
    reference's labels)."""
    from repro_torch.core.schemes import registered_schemes
    from repro_torch.kernels.fused_cnn.ops import ForwardPolicy
    variants: List[Tuple[str, Dict]] = [
        (name, {}) for name in (schemes or registered_schemes())]
    variants.append(("opt", {"use_codec": True, "compress_ratio": 0.252}))
    variants.append(("opt", {"forward": ForwardPolicy(kernel="pallas",
                                                      interpret=True)}))
    return [(name + ("" if not extra else f"+{sorted(extra)}"), name, extra)
            for name, extra in variants]


def device_round_signature(scheme: str, extra: Dict, device
                           ) -> Tuple[Any, Any, Any]:
    """``(carry in, carry out, metrics)`` specs of one round of
    ``build_device_round`` at the contract's sizes (run for real)."""
    from repro_torch.core.channel_lib import ChannelParams
    from repro_torch.core.fused_round import build_device_round
    round_fn = build_device_round(
        scheme=scheme, local_epochs=_E, steps_per_epoch=_STEPS,
        batch_size=_BS, lr=0.01, k_select=_K, channel=ChannelParams(),
        model_bytes=1e6, ue_model_fraction=0.25, **extra)
    carry, stream, sim, cfg = device_round_inputs(device)
    carry_in = spec_tree(carry)
    out_carry, metrics = round_fn(carry, 1, stream, sim, cfg)
    return carry_in, spec_tree(out_carry), spec_tree(metrics)


def check_device_round(schemes=None, device=None) -> List[Finding]:
    """Contract 1: per-scheme carry stability of build_device_round, on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    findings: List[Finding] = []
    g = _S * _C
    for label, name, extra in device_round_variants(schemes):
        try:
            carry_in, carry_out, metrics = device_round_signature(
                name, extra, device)
        except Exception as exc:  # a broken build IS the finding
            findings.append(Finding(
                _FUSED_PATH, 1, 0, "contract-device-round",
                f"build_device_round({label}) failed evaluation: "
                f"{type(exc).__name__}: {exc}"))
            continue
        for d in diff_signatures(carry_in, carry_out):
            findings.append(Finding(
                _FUSED_PATH, 1, 0, "contract-device-round",
                f"scheme {label!r}: DeviceSimCarry is not round-stable "
                f"(in != out): {d}"))
        for field, want in DEVICE_METRIC_DTYPES.items():
            got = getattr(metrics, field)
            if tuple(got.shape) != (g,) or got.dtype != want:
                findings.append(Finding(
                    _FUSED_PATH, 1, 0, "contract-device-round",
                    f"scheme {label!r}: metrics.{field} is "
                    f"{tuple(got.shape)} {dtype_name(got.dtype)}, declared "
                    f"({g},) {dtype_name(want)}"))
    return findings


FUSED_STATS_DTYPES = {"arrived": torch.bool, "rescued": torch.bool,
                      "delayed": torch.bool, "dropped": torch.bool,
                      "opp_sends": torch.int32}


def fused_round_inputs(device) -> Tuple[Any, Any, Any, Dict]:
    """``(params, xs, ys, chan)`` of the fused round's contract."""
    gen = torch.Generator().manual_seed(_SEED)
    f32, b8 = torch.float32, torch.bool
    xs = _real(Spec((_E, _K, _STEPS, _BS) + _IMG, f32), gen, device)
    ys = _real(Spec((_E, _K, _STEPS, _BS), torch.int64), gen, device)
    chan = {
        "rates": _real(Spec((_E, _K), f32), gen, device).abs() * 1e7,
        "outages": _real(Spec((_E, _K), b8), gen, device),
        "payload_bits": torch.full((_K,), 8e6, device=device),
        "tau_extra0": torch.full((_K,), 1.0, device=device),
        "final_rate": torch.full((_K,), 1e7, device=device),
        "train_time": torch.full((_K,), 2.0, device=device),
        "final_outage": _real(Spec((_K,), b8), gen, device),
        "valid": torch.ones(_K, dtype=b8, device=device),
    }
    return _example_params(device), xs, ys, chan


def fused_round_signature(name: str, device) -> Dict[str, Any]:
    """The fused round's input and output specs for scheme ``name`` (run
    for real): ``params``, ``new_params``, ``stats`` and, for schemes that
    carry stragglers, ``delayed_stack``/``delayed_mask`` in and out."""
    from repro_torch.core.fused_round import build_fused_round
    from repro_torch.core.schemes import get_scheme
    scheme = get_scheme(name)
    kw: Dict[str, Any] = dict(
        scheme=name, local_epochs=_E, steps_per_epoch=_STEPS, lr=0.01,
        tau_max=9.0, probe_epochs=scheme.static_schedule(_E, 2))
    params, xs, ys, chan = fused_round_inputs(device)
    out: Dict[str, Any] = {"params": spec_tree(params)}
    if scheme.carries_delayed:
        fn = build_fused_round(k_carry=_K, async_weight=0.283, **kw)
        stack = _map(lambda t: torch.zeros((_K,) + tuple(t.shape),
                                           device=device), params)
        mask = torch.zeros(_K, dtype=torch.bool, device=device)
        out["delayed_stack"], out["delayed_mask"] = (spec_tree(stack),
                                                     spec_tree(mask))
        new_params, new_stack, new_mask, stats = fn(params, stack, mask, xs,
                                                    ys, chan)
        out["new_delayed_stack"] = spec_tree(new_stack)
        out["new_delayed_mask"] = spec_tree(new_mask)
    else:
        fn = build_fused_round(**kw)
        new_params, stats = fn(params, xs, ys, chan)
    out["new_params"], out["stats"] = spec_tree(new_params), spec_tree(stats)
    return out


def check_fused_round(schemes=None, device=None) -> List[Finding]:
    """Contract 2: build_fused_round preserves the params' specs, on
    ``device`` (``None``: the card)."""
    from repro_torch.core.schemes import registered_schemes
    device = resolve_device(device)

    findings: List[Finding] = []
    for name in (schemes or registered_schemes()):
        try:
            sig = fused_round_signature(name, device)
        except Exception as exc:
            findings.append(Finding(
                _FUSED_PATH, 1, 0, "contract-fused-round",
                f"build_fused_round({name!r}) failed evaluation: "
                f"{type(exc).__name__}: {exc}"))
            continue
        for d in diff_signatures(sig["params"], sig["new_params"]):
            findings.append(Finding(
                _FUSED_PATH, 1, 0, "contract-fused-round",
                f"scheme {name!r}: new_params drifts from params "
                f"(breaks in-place chaining): {d}"))
        for label in ("delayed_stack", "delayed_mask"):
            if label not in sig:
                continue
            for d in diff_signatures(sig[label], sig["new_" + label]):
                findings.append(Finding(
                    _FUSED_PATH, 1, 0, "contract-fused-round",
                    f"scheme {name!r}: {label} is not round-stable: {d}"))
        for field, want in FUSED_STATS_DTYPES.items():
            got = getattr(sig["stats"], field)
            if tuple(got.shape) != (_K,) or got.dtype != want:
                findings.append(Finding(
                    _FUSED_PATH, 1, 0, "contract-fused-round",
                    f"scheme {name!r}: RoundStats.{field} is "
                    f"{tuple(got.shape)} {dtype_name(got.dtype)}, declared "
                    f"({_K},) {dtype_name(want)}"))
    return findings


def check_scheme_programs() -> List[Finding]:
    """Contract 4: lowered_program resolves inside the registry."""
    from repro_torch.core.schemes import get_scheme, registered_schemes
    findings: List[Finding] = []
    names = registered_schemes()
    for name in names:
        scheme = get_scheme(name)
        for pins in ((1.0,), (2.0,), (1.0, 2.0, 4.0)):
            prog = scheme.lowered_program(pins)
            if prog not in names:
                findings.append(Finding(
                    _SCHEMES_PATH, 1, 0, "contract-scheme-program",
                    f"scheme {name!r}: lowered_program({pins}) -> "
                    f"{prog!r}, which is not a registered scheme"))
    return findings


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------

def compare_twin(name: str, path: str, ref_thunk: Callable[[], Any],
                 kernel_thunk: Callable[[], Any]) -> List[Finding]:
    """Findings if two evaluations disagree (or either fails)."""
    outs = {}
    for side, thunk in (("ref", ref_thunk), ("kernel", kernel_thunk)):
        try:
            outs[side] = thunk()
        except Exception as exc:
            return [Finding(path, 1, 0, "contract-kernel-twin",
                            f"{name}: {side} side failed evaluation: "
                            f"{type(exc).__name__}: {exc}")]
    return [Finding(path, 1, 0, "contract-kernel-twin",
                    f"{name}: ref/kernel signatures differ: {d}")
            for d in diff_signatures(outs["ref"], outs["kernel"])]


def twin_registry(device) -> List[Tuple[str, str, Callable, Callable]]:
    """Every kernels/* ref/kernel twin pair as (name, path, ref, kernel),
    under the reference's names (the moe dispatch pairs, which replace no
    TPU kernel, under the port's).

    Each thunk returns a spec tree: a side that is plain torch runs
    ``abstract``ally, a side that goes through a kernel wrapper
    ``concrete``ly on ``device`` (on the card, the kernel launches).
    Both wkv6 sides take the user-facing (B, S, H, D) layout
    (``ops.wkv6`` folds it to the kernel's (BH, S, D)), so "identical
    signature" means identical *user-facing* outputs."""
    import repro_torch.kernels.delta_codec.kernel as dck
    import repro_torch.kernels.delta_codec.ref as dcr
    import repro_torch.kernels.flash_attention.kernel as fak
    import repro_torch.kernels.flash_attention.ref as far
    import repro_torch.kernels.fused_cnn.ops as cnn_ops
    import repro_torch.kernels.fused_cnn.ref as cnn_ref
    import repro_torch.kernels.moe_dispatch.kernel as mdk
    import repro_torch.kernels.moe_dispatch.ref as mdr
    import repro_torch.kernels.wkv6.ops as wko
    import repro_torch.kernels.wkv6.ref as wkr
    from repro_torch.kernels.fused_cnn.ops import ForwardPolicy

    device = resolve_device(device)
    f32 = torch.float32

    def ab(fn, *specs):
        return abstract(fn, *specs, device=device)

    def real(fn, *specs):
        return concrete(fn, *specs, device=device)

    pairs: List[Tuple[str, str, Callable, Callable]] = []

    # -- delta_codec ------------------------------------------------------
    path = f"{_KERNELS}/delta_codec/kernel.py"
    x = Spec((256, 512), f32)
    q, s = Spec((256, 512), torch.int8), Spec((256, 1), f32)
    for bits in (8, 4):
        pairs.append((
            f"delta_codec.quantize[bits={bits}]", path,
            lambda bits=bits: ab(lambda a: dcr.quantize_ref(a, bits=bits), x),
            lambda bits=bits: real(lambda a: dck.quantize_blocks(
                a, bits=bits), x)))
    pairs.append((
        "delta_codec.dequantize", path,
        lambda: ab(dcr.dequantize_ref, q, s),
        lambda: real(dck.dequantize_blocks, q, s)))

    # -- flash_attention --------------------------------------------------
    path = f"{_KERNELS}/flash_attention/kernel.py"
    qa = Spec((4, 256, 64), f32)
    for label, kw in (("causal", dict(causal=True)),
                      ("window", dict(causal=True, window=128))):
        pairs.append((
            f"flash_attention.{label}", path,
            lambda kw=kw: ab(lambda a, b, c: far.flash_attention_bh_ref(
                a, b, c, **kw), qa, qa, qa),
            lambda kw=kw: real(lambda a, b, c: fak.flash_attention_bh(
                a, b, c, **kw), qa, qa, qa)))

    # -- wkv6 -------------------------------------------------------------
    B, S, H, D = 2, 256, 2, 64
    r = Spec((B, S, H, D), f32)
    u = Spec((H, D), f32)
    s0 = Spec((B, H, D, D), f32)
    pairs.append((
        "wkv6.recurrence", f"{_KERNELS}/wkv6/kernel.py",
        lambda: ab(wkr.wkv_scan, r, r, r, r, u, s0),
        lambda: real(wko.wkv6, r, r, r, r, u)))

    # -- fused_cnn --------------------------------------------------------
    path = f"{_KERNELS}/fused_cnn/kernel.py"
    params = spec_tree(_example_params("cpu"))
    img = Spec((_BS,) + _IMG, f32)
    base = ForwardPolicy(interpret=True)
    for kernel in ("pallas", "im2col"):
        pol = ForwardPolicy(kernel=kernel, interpret=True)
        pairs.append((
            f"fused_cnn.forward[{kernel} vs xla]", path,
            lambda: real(cnn_ops.make_forward(base), params, img),
            lambda pol=pol: real(cnn_ops.make_forward(pol), params, img)))
    # the hand-written backward's forward against the plain reference fwd
    pairs.append((
        "fused_cnn.forward[ref oracle]", f"{_KERNELS}/fused_cnn/ref.py",
        lambda: ab(cnn_ref.forward_ref, params, img),
        lambda: real(cnn_ops.make_forward(base), params, img)))
    # stacked-cohort twins: blocked kernels vs the per-user composition
    stacked = _map(lambda sp: Spec((_K,) + sp.shape, sp.dtype), params)
    bx = Spec((_K, _BS) + _IMG, f32)
    by = Spec((_K, _BS), torch.int64)
    vm = ForwardPolicy(interpret=True, batch_users=False)
    for label, pol in (("xla", base),
                       ("pallas", ForwardPolicy(kernel="pallas",
                                                interpret=True)),
                       ("block_k", ForwardPolicy(interpret=True, block_k=2)),
                       ("bf16", ForwardPolicy(precision="bf16",
                                              interpret=True))):
        pairs.append((
            f"fused_cnn.stacked_loss_grad[{label} vs vmapped]", path,
            lambda: real(cnn_ops.make_stacked_loss_grad(vm), stacked, bx, by),
            lambda pol=pol: real(cnn_ops.make_stacked_loss_grad(pol),
                                 stacked, bx, by)))

    # -- moe_dispatch -----------------------------------------------------
    # These kernels replace no TPU kernel (the reference dispatches in
    # jnp); the names are the port's.  T = 128 tokens, k = 2 of E = 10
    # experts (the seeded ints lie in [0, 10)), C = 16 slots each, d = 64;
    # the seeded slots of the combine are kept rows, some shared
    path = f"{_KERNELS}/moe_dispatch/kernel.py"
    T, k, E, C, d = 128, 2, 10, 16, 64
    fe = Spec((T * k,), torch.int64)

    def scatter(a, e):
        slot, _, counts = mdk.moe_slots(e, E, C)
        return mdk.moe_scatter(a, slot, counts, E, C, k)

    pairs.append((
        "moe_dispatch.slots", path,
        lambda: ab(lambda e: mdr.slots_ref(e, E, C), fe),
        lambda: real(lambda e: mdk.moe_slots(e, E, C), fe)))
    pairs.append((
        "moe_dispatch.scatter", path,
        lambda: ab(lambda a, e: mdr.scatter_ref(
            a, mdr.slots_ref(e, E, C)[0], E, C, k), Spec((T, d), f32), fe),
        lambda: real(scatter, Spec((T, d), f32), fe)))
    for dt in (f32, torch.bfloat16):
        o, w = Spec((E, C, d), dt), Spec((T * k,), dt)
        pairs.append((
            f"moe_dispatch.combine[{dtype_name(dt)}]", path,
            lambda o=o, w=w: ab(lambda a, s, b: mdr.combine_ref(a, s, b, k),
                                o, fe, w),
            lambda o=o, w=w: real(
                lambda a, s, b: mdk.moe_combine(a, s, b, k), o, fe, w)))
    return pairs


def covered_twin_packages() -> set:
    return {name.split(".")[0] for name, _, _, _ in twin_registry("cpu")}


def kernel_twin_packages(repo_root: Path) -> set:
    """kernels/* packages shipping a ref.py/kernel.py twin pair."""
    kdir = repo_root / "src" / "repro_torch" / "kernels"
    return {d.name for d in kdir.iterdir()
            if d.is_dir() and (d / "ref.py").exists()
            and (d / "kernel.py").exists()}


def check_kernel_twins(repo_root: Path | None = None,
                       device=None) -> List[Finding]:
    """Contract 3: twin signatures agree + every twin package is covered,
    on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    findings: List[Finding] = []
    registry = twin_registry(device)
    for name, path, ref_thunk, kernel_thunk in registry:
        findings.extend(compare_twin(name, path, ref_thunk, kernel_thunk))
    if repo_root is not None:
        covered = {name.split(".")[0] for name, _, _, _ in registry}
        for pkg in sorted(kernel_twin_packages(repo_root) - covered):
            findings.append(Finding(
                f"{_KERNELS}/{pkg}/kernel.py", 1, 0,
                "contract-kernel-twin",
                f"kernels/{pkg} ships a ref.py/kernel.py twin pair but "
                f"has no entry in analysis.contracts.twin_registry()"))
    return findings


def run_contracts(repo_root: Path | None = None,
                  device=None) -> List[Finding]:
    """The full contract sweep (every registered scheme, every twin) on
    ``device`` (``None``: the card, which must be there)."""
    device = resolve_device(device)
    findings: List[Finding] = []
    findings.extend(check_scheme_programs())
    findings.extend(check_device_round(device=device))
    findings.extend(check_fused_round(device=device))
    findings.extend(check_kernel_twins(repo_root, device=device))
    return findings
