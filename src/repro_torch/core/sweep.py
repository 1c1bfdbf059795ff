"""The sweep engine: whole Fig. 3 panels on the device
(``repro/core/sweep.py``).

A ``SweepSpec`` declares a grid: schemes (with their pins), seeds x
distributions (the simulation rows) and b x τ_max x bandwidth_ratio (the
config columns).  ``compile_spec`` turns it into groups, exactly as the
reference does: one group per scheme entry, statics pinned per group, and
a b=1 discard group lowered onto the opt program (discard is opt with zero
probes), so a Fig. 3(b) panel needs 2 round programs, not 3.

The reference compiles one program per group: rounds under ``lax.scan``,
configs and simulations under ``vmap``.  The port cannot vmap a kernel
launch, so it folds both vmapped axes into the user axis of the blocked
kernels (``fused_round.build_device_round``): a group's S simulations x C
configs train as one cohort of S·C·K users, one launch per layer per
step, and its rounds run as a Python loop that reads nothing back to the
host.  The metrics come back to numpy once per group.

Randomness: each simulation draws from its own stream (``core/streams``),
seeded from its seed, so a row does not depend on the rest of its group.
The default streams are ``torch.Generator``s: a sweep is seeded and
reproducible, but its draws are not the reference's (a test can replay
those through ``stream_factory``).  Datasets, partitions and device FLOPS
are the host runs' (``hsfl.build_sim_arrays``); the initial params are
the port's ``init_cnn(seed)``, as in ``HSFLSimulation``.

Over ranks (``mesh``: a process group from ``launch.mesh.make_sweep_mesh``)
each rank runs its block of every group's simulation rows
(``sharding.rules.sweep_rows``: contiguous blocks when the ranks divide
the rows, else every row on every rank), with no collective inside the
round loop; then each rank broadcasts its rows' metrics and final params
in turn, so that every rank returns the whole ``SweepResult``.  Rows do
not depend on their group, so the gathered result is the unsharded one.
"""
from __future__ import annotations

import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.channel_lib import fleet_init
from repro_torch.core.fused_round import (DeviceRoundMetrics, DeviceSimCarry,
                                          _rep, build_device_round)
from repro_torch.core.hsfl import (HSFLConfig, build_sim_arrays,
                                   model_compress_ratio)
from repro_torch.core.metrics import RoundLog, SimLog
from repro_torch.core.schemes import get_scheme
from repro_torch.core.streams import GroupStream, torch_stream
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_cnn.ops import ForwardPolicy
from repro_torch.sharding.rules import sweep_rows
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# fields of HSFLConfig a sweep varies per config column
CFG_AXES = ("b", "tau_max", "bandwidth_ratio")

# HSFLConfig fields a scheme entry may pin as group statics: they fork
# another round program (the scheme itself is the first of them)
GROUP_STATICS = ("use_delta_codec", "codec_block", "codec_bits", "kernel",
                 "precision", "block_k", "batch_users")

# what compile_spec writes into ``group.base.b`` when b is swept on the
# config axis: nothing static may read it
B_SWEPT = -1


@dataclass(frozen=True)
class SweepSpec:
    """A declarative experiment grid (one Fig. 3 panel, typically).

    ``schemes`` entries are registered names (``"opt"``), ``Scheme``
    objects with their pins (``get_scheme("opt").with_pins(b=2.0)``) or
    ``("opt", {"b": 2})`` tuples.  ``b``/``tau_max``/``bandwidth_ratio``
    form the config columns (their product); ``seeds`` x ``distributions``
    the simulation rows."""
    base: HSFLConfig = field(default_factory=HSFLConfig)
    seeds: Tuple[int, ...] = (0,)
    schemes: Tuple = ()                  # () -> (base.scheme,)
    distributions: Tuple[str, ...] = ()  # () -> (base.distribution,)
    b: Tuple[float, ...] = ()            # () -> (base.b,)
    tau_max: Tuple[float, ...] = ()      # () -> (base.tau_max,)
    bandwidth_ratio: Tuple[float, ...] = ()   # () -> (1.0,)


@dataclass(frozen=True)
class CompiledGroup:
    """One result slice of a SweepSpec: fixed statics, stacked axes.
    ``program_scheme`` is the scheme whose round runs the group (discard
    pinned at b=1 runs opt's); ``label`` tells same-scheme groups apart."""
    scheme: str
    base: HSFLConfig                      # statics for this group
    sims: Tuple[Tuple[int, str], ...]     # (seed, distribution) per row
    cfgs: Tuple[Dict[str, float], ...]    # config values per column
    label: str = ""
    program_scheme: str = ""


def compile_spec(spec: SweepSpec,
                 lower_discard: bool = True) -> List[CompiledGroup]:
    """SweepSpec -> groups.  Pins of ``GROUP_STATICS`` fields fork the
    group's statics, pins of ``CFG_AXES`` fix that axis for the group, any
    other pin raises.  ``base.b`` is pinned when the group has one b and
    set to ``B_SWEPT`` when b is swept (then a ``schedule_override``
    raises).  ``lower_discard=False`` keeps discard's own program."""
    schemes = spec.schemes or (spec.base.scheme,)
    dists = spec.distributions or (spec.base.distribution,)
    sims = tuple(itertools.product(spec.seeds, dists))
    groups = []
    for entry in schemes:
        if isinstance(entry, tuple):
            name, tuple_pins = entry
            scheme_obj = get_scheme(name).with_pins(**tuple_pins)
        else:
            scheme_obj = get_scheme(entry)
        scheme, pins = scheme_obj.name, dict(scheme_obj.pins)
        axes = {
            "b": spec.b or (spec.base.b,),
            "tau_max": spec.tau_max or (spec.base.tau_max,),
            "bandwidth_ratio": spec.bandwidth_ratio or (1.0,),
        }
        statics = {}
        for k, v in pins.items():         # pins win, even over swept axes
            if k in GROUP_STATICS:
                statics[k] = v
            elif k in CFG_AXES:
                axes[k] = (v,)
            else:
                raise ValueError(f"scheme pin {k!r} is neither a traced "
                                 f"axis {CFG_AXES} nor a group static "
                                 f"{GROUP_STATICS}")
        cfgs = tuple({"b": float(b), "tau_max": float(t),
                      "bandwidth_ratio": float(w)}
                     for b, t, w in itertools.product(*axes.values()))
        base = replace(spec.base, scheme=scheme, **statics)
        b_vals = sorted({c["b"] for c in cfgs})
        if len(b_vals) == 1:
            base = replace(base, b=int(max(1, round(b_vals[0]))))
        else:
            if spec.base.schedule_override:
                raise ValueError(
                    "schedule_override is a static of the compiled round "
                    "program, but b is swept on the traced config axis "
                    f"({b_vals}); pin b per scheme or drop the override")
            base = replace(base, b=B_SWEPT)
        program = (scheme_obj.lowered_program(tuple(b_vals))
                   if lower_discard else scheme)
        groups.append(CompiledGroup(
            scheme=scheme, base=base, sims=sims, cfgs=cfgs,
            label=scheme + ("+codec" if base.use_delta_codec else ""),
            program_scheme=program))
    return groups


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    """The process's pool for building simulations' arrays, one worker a
    usable CPU: made once, and dropped in a forked child, whose copy of
    it has no threads."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                   thread_name_prefix="sim_arrays")
    return _POOL


def _drop_pool() -> None:
    global _POOL
    _POOL = None


os.register_at_fork(after_in_child=_drop_pool)


def _stack_sims(group: CompiledGroup) -> Dict[str, np.ndarray]:
    """Build + stack per-sim constant arrays, padded to a common length.

    Each simulation's arrays come from ``build_sim_arrays`` (looked up
    here, so a wrapper of the module's attribute sees every call).  With
    more than one simulation and more than one usable CPU the calls run
    on ``_pool()``, min(simulations, CPUs) at once: numpy releases the
    GIL inside the array operations they are made of.  The stacked
    arrays are then written once, each simulation's slice by a worker.
    Counters (from the calling thread): ``sweep.sims_built`` and
    ``sweep.sims_built_concurrently``."""
    cfgs = [replace(group.base, seed=seed, distribution=dist)
            for seed, dist in group.sims]
    concurrent = len(cfgs) > 1 and len(os.sched_getaffinity(0)) > 1
    run = _pool().map if concurrent else map
    per_sim = list(run(build_sim_arrays, cfgs))
    m = max(a["client_x"].shape[1] for a in per_sim)
    shapes = {k: v.shape for k, v in per_sim[0].items()}
    for k in ("client_x", "client_y"):
        shapes[k] = shapes[k][:1] + (m,) + shapes[k][2:]
    out = {k: np.empty((len(per_sim),) + shapes[k], v.dtype)
           for k, v in per_sim[0].items()}

    def fill(i: int) -> None:
        for k, v in per_sim[i].items():
            dst = out[k][i]
            if v.shape != dst.shape:          # clients shorter than m
                dst[:, v.shape[1]:] = 0
                dst = dst[:, :v.shape[1]]
            dst[...] = v

    list(run(fill, range(len(per_sim))))
    trace.count("sweep.sims_built", len(cfgs))
    trace.count("sweep.sims_built_concurrently", len(cfgs) if concurrent
                else 0)
    return out


def _sim_tensors(arrays: Dict[str, np.ndarray], device) -> Dict:
    """The stacked sim arrays on ``device``; labels and lengths int64
    (they index)."""
    out = {}
    for k, v in arrays.items():
        if k in ("client_y", "test_y", "client_len"):
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def _group_build_kwargs(group: CompiledGroup) -> Dict[str, Any]:
    """The static kwargs ``build_device_round`` gets for this group, and
    the program's identity (``_program_key``): not ``base.scheme`` nor
    ``base.b`` (the program runs ``program_scheme``, b is a column)."""
    base = group.base
    return dict(
        scheme=group.program_scheme or group.scheme,
        local_epochs=base.local_epochs,
        steps_per_epoch=base.steps_per_epoch, batch_size=base.batch_size,
        lr=base.lr, k_select=base.k_select, channel=base.channel,
        model_bytes=base.model_bytes,
        ue_model_fraction=base.ue_model_fraction,
        compress_ratio=model_compress_ratio(base),
        use_codec=base.use_delta_codec, codec_block=base.codec_block,
        codec_bits=base.codec_bits,
        forward=ForwardPolicy(kernel=base.kernel,
                              precision=base.precision,
                              block_k=base.block_k,
                              batch_users=base.batch_users).validate(),
        schedule_override=tuple(base.schedule_override),
        async_alpha=base.async_alpha, async_a=base.async_a)


def _program_key(group: CompiledGroup) -> Tuple:
    """Hashable identity of the round program a group needs."""
    kw = _group_build_kwargs(group)
    kw["channel"] = repr(kw["channel"])       # mutable dataclass -> repr
    return tuple(sorted(kw.items()))


def _group_inputs(group: CompiledGroup, data: Dict, device,
                  stream_factory: Callable = torch_stream):
    """``(carry0, streams, cfg)`` of a group: each simulation's stream
    (``stream_factory(cfg_of_the_sim, device)``), its initial params and
    fleet, every config row's copy of the params, a zero straggler stack,
    and the config columns as (C,) f32 tensors."""
    base = group.base
    streams = GroupStream([
        stream_factory(replace(base, seed=seed, distribution=dist), device)
        for seed, dist in group.sims])
    per_sim = streams.init_params()
    c, k = len(group.cfgs), base.k_select
    params0 = tree_map(lambda *ls: _rep(torch.stack(ls), c), *per_sim)
    fleet0 = fleet_init(streams.fleet_init_draws(base.n_uavs, base.channel),
                        base.channel)
    g = len(group.sims) * c
    carry0 = DeviceSimCarry(
        params=params0, fleet=fleet0,
        delayed=tree_map(lambda a: torch.zeros((g, k) + a.shape[1:],
                                               dtype=a.dtype, device=device),
                         params0),
        delayed_mask=torch.zeros((g, k), dtype=torch.bool, device=device))
    cfg = {key: torch.tensor([cf[key] for cf in group.cfgs],
                             dtype=torch.float32, device=device)
           for key in CFG_AXES}
    return carry0, streams, cfg


def _scan_rounds(round_fn: Callable, carry: DeviceSimCarry, streams,
                 data: Dict, cfg: Dict, rounds: int):
    """The round loop of a group: ``rounds`` rounds, nothing read back.
    Returns the final carry and each round's ``DeviceRoundMetrics``."""
    out = []
    for t in range(1, rounds + 1):
        carry, m = round_fn(carry, t, streams, data, cfg)
        out.append(m)
    return carry, out


def _stack_metrics(per_round: List[DeviceRoundMetrics]) -> torch.Tensor:
    """The rounds' metrics as one f32 (fields, rows, rounds) tensor on the
    device (the counts are exact in f32)."""
    return torch.stack([torch.stack([getattr(m, f).to(torch.float32)
                                     for m in per_round], dim=-1)
                        for f in DeviceRoundMetrics._fields])


def _read_metrics(per_round: List[DeviceRoundMetrics], s: int,
                  c: int) -> Dict[str, np.ndarray]:
    """The rounds' metrics in one read: each (S, C, rounds), counts int32,
    the rest f32."""
    return _metrics_numpy(_stack_metrics(per_round), s, c)


def _metrics_numpy(allm: torch.Tensor, s: int,
                   c: int) -> Dict[str, np.ndarray]:
    """``_stack_metrics``' tensor, read back: each field (S, C, rounds)."""
    fields = DeviceRoundMetrics._fields
    allm = allm.cpu().numpy()
    out = {}
    for f, a in zip(fields, allm):
        a = a.reshape(s, c, a.shape[-1])
        out[f] = a.astype(np.float32 if f in ("bytes_sent", "test_loss",
                                              "test_acc") else np.int32)
    return out


@dataclass
class GroupResult:
    scheme: str
    sims: Tuple[Tuple[int, str], ...]
    cfgs: Tuple[Dict[str, float], ...]
    metrics: Dict[str, np.ndarray]        # each (S, C, rounds)
    run_s: float = 0.0
    label: str = ""                       # scheme (+ "+codec")
    program_id: int = 0                   # same id: the same round program
    final_params: Any = None              # (S·C, ...) leaves on the device

    def sim_log(self, sim_i: int, cfg_i: int) -> SimLog:
        """The loop engine's SimLog for one (sim, config) cell."""
        log = SimLog()
        m = self.metrics
        for t in range(m["test_acc"].shape[-1]):
            log.add(RoundLog(
                round=t + 1,
                selected=int(m["selected"][sim_i, cfg_i, t]),
                arrived_final=int(m["arrived"][sim_i, cfg_i, t]),
                used_snapshot=int(m["rescued"][sim_i, cfg_i, t]),
                dropped=int(m["dropped"][sim_i, cfg_i, t]),
                delayed=int(m["delayed"][sim_i, cfg_i, t]),
                bytes_sent=float(m["bytes_sent"][sim_i, cfg_i, t]),
                test_loss=float(m["test_loss"][sim_i, cfg_i, t]),
                test_acc=float(m["test_acc"][sim_i, cfg_i, t])))
        return log


@dataclass
class SweepResult:
    groups: List[GroupResult]
    rounds: int
    n_programs: int = 0                   # distinct round programs

    @property
    def n_simulations(self) -> int:
        return sum(len(g.sims) * len(g.cfgs) for g in self.groups)


def _sweep_group(mesh: Any):
    """``mesh`` as the process group a sweep splits its rows over, or None
    for one device."""
    if mesh is None:
        return None
    if isinstance(mesh, str) and mesh == "auto":
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            return dist.group.WORLD
        return None
    if dist.is_available() and isinstance(mesh, dist.ProcessGroup):
        if dist.get_rank(mesh) < 0:
            raise ValueError(f"rank {dist.get_rank()} is not in the sweep's "
                             "process group")
        return mesh
    raise TypeError(
        f"mesh takes None, 'auto' or a torch.distributed process group "
        f"(repro_torch.launch.mesh.make_sweep_mesh); got {mesh!r}")


def _gather_rows(group, allm: torch.Tensor, params: Any):
    """Every rank's ``(fields, rows, rounds)`` metrics and ``(rows, ...)``
    params, concatenated along the rows in rank order: each rank packs its
    own into one f32 buffer and broadcasts it in turn (exact; gloo has no
    all-gather of CUDA tensors)."""
    leaves = tree_leaves(params)
    mine = torch.cat([allm.reshape(-1)]
                     + [x.to(torch.float32).reshape(-1) for x in leaves])
    me = dist.get_rank(group)
    blocks = []
    for r in range(dist.get_world_size(group)):
        buf = mine if r == me else torch.empty_like(mine)
        dist.broadcast(buf, src=dist.get_global_rank(group, r), group=group)
        blocks.append(buf)
    ms, ps = [], [[] for _ in leaves]
    for buf in blocks:
        ms.append(buf[:allm.numel()].view(allm.shape))
        off = allm.numel()
        for i, x in enumerate(leaves):
            ps[i].append(buf[off:off + x.numel()].view(x.shape).to(x.dtype))
            off += x.numel()
    return (torch.cat(ms, dim=1),
            tree_unflatten(params, iter(torch.cat(p) for p in ps)))


def _run_sweep(spec: SweepSpec, mesh: Any = "auto", verbose: bool = False,
               timeit: bool = False, lower_discard: bool = True, device=None,
               stream_factory: Callable = torch_stream,
               overlap_compile: bool = True) -> SweepResult:
    """Run a SweepSpec: one round function per distinct program key
    (``_program_key``; a b=1 discard group runs opt's), each group's rounds
    with its S·C rows folded into the kernels' user axis, the metrics read
    once per group.

    ``device=None`` is the CUDA card (``repro_torch.device``; a spawned
    rank's own card).  ``mesh`` takes ``None`` (one device), a process
    group from ``launch.mesh.make_sweep_mesh`` (each rank runs its block
    of the simulation rows, then the rows are gathered; see the module's
    docstring), or ``"auto"``: the default group when ``torch.distributed``
    is initialised with more than one rank, else one device.  ``timeit``
    runs each group a second time from its streams and reports that run's
    ``run_s`` (this rank's).  There is no compile step: ``overlap_compile``
    (the reference's background compile of the next group) is taken and
    has no effect.  ``stream_factory(cfg, device)`` makes each
    simulation's stream (``cfg.seed`` is the simulation's).

    Host spans (``utils.trace``): ``sweep.program`` (a new round program),
    ``sweep.sim_arrays`` (the host data and its copy to the device),
    ``sweep.group_inputs``, ``sweep.rounds`` (the round loop; each round's
    spans inside it), ``sweep.read`` (the metrics' one read) and, over
    ranks, ``sweep.gather``.  Counters: ``sweep.sims_built`` (the
    simulations whose arrays a group built) and
    ``sweep.sims_built_concurrently`` (those built on the pool)."""
    group_pg = _sweep_group(mesh)
    device = resolve_device(device)
    rounds = spec.base.rounds
    programs: Dict[Tuple, Tuple[Callable, int]] = {}
    sims_data: Dict[Tuple, Dict] = {}
    out = []
    for group in compile_spec(spec, lower_discard=lower_discard):
        key = _program_key(group)
        if key not in programs:
            with trace.span("sweep.program"):
                programs[key] = (
                    build_device_round(**_group_build_kwargs(group)),
                    len(programs))
        fn, pid = programs[key]
        n_sims = len(group.sims)
        lo, hi = (0, n_sims) if group_pg is None else sweep_rows(
            n_sims, dist.get_world_size(group_pg), dist.get_rank(group_pg))
        block = replace(group, sims=group.sims[lo:hi])
        if block.sims not in sims_data:
            with trace.span("sweep.sim_arrays"):
                sims_data[block.sims] = _sim_tensors(_stack_sims(block),
                                                     device)
        data = sims_data[block.sims]
        for _ in range(2 if timeit else 1):
            with trace.span("sweep.group_inputs"):
                carry, streams, cfg = _group_inputs(block, data, device,
                                                    stream_factory)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with trace.span("sweep.rounds"):
                carry, per_round = _scan_rounds(fn, carry, streams, data,
                                                cfg, rounds)
            with trace.span("sweep.read"):
                allm = _stack_metrics(per_round)
                metrics = _metrics_numpy(allm, hi - lo, len(group.cfgs))
            run_s = time.perf_counter() - t0
        params = carry.params
        if hi - lo < n_sims:
            with trace.span("sweep.gather"):
                allm, params = _gather_rows(group_pg, allm, params)
                metrics = _metrics_numpy(allm, n_sims, len(group.cfgs))
        out.append(GroupResult(
            scheme=group.scheme, sims=group.sims, cfgs=group.cfgs,
            metrics=metrics, run_s=round(run_s, 3),
            label=group.label or group.scheme, program_id=pid,
            final_params=params))
        if verbose and (group_pg is None or dist.get_rank(group_pg) == 0):
            accs = out[-1].metrics["test_acc"][..., -1]
            print(f"[sweep/{out[-1].label}] sims={n_sims} "
                  f"cfgs={len(group.cfgs)} rounds={rounds} "
                  f"run={out[-1].run_s:.2f}s final_acc={accs.mean():.4f}")
    return SweepResult(groups=out, rounds=rounds, n_programs=len(programs))


def run_sweep(spec: SweepSpec, mesh: Any = "auto", verbose: bool = False,
              timeit: bool = False, lower_discard: bool = True, device=None,
              stream_factory: Callable = torch_stream,
              overlap_compile: bool = True) -> SweepResult:
    """Deprecated entry point; use ``repro_torch.api.Experiment``::

        Experiment.from_spec(spec).run(engine="sweep")"""
    import warnings
    warnings.warn("run_sweep is deprecated; use repro_torch.api.Experiment"
                  ".from_spec(spec).run(engine='sweep')",
                  DeprecationWarning, stacklevel=2)
    return _run_sweep(spec, mesh=mesh, verbose=verbose, timeit=timeit,
                      lower_discard=lower_discard, device=device,
                      stream_factory=stream_factory,
                      overlap_compile=overlap_compile)


def run_hsfl_on_device(cfg: HSFLConfig, mesh: Any = None,
                       device=None) -> SimLog:
    """Deprecated entry point; use ``repro_torch.api.Experiment``::

        Experiment(cfg).run(engine="sweep").groups[0].sim_log(0, 0)"""
    import warnings
    warnings.warn("run_hsfl_on_device is deprecated; use repro_torch.api."
                  "Experiment(cfg).run(engine='sweep')",
                  DeprecationWarning, stacklevel=2)
    spec = SweepSpec(base=cfg, seeds=(cfg.seed,))
    res = _run_sweep(spec, mesh=mesh, device=device)
    return res.groups[0].sim_log(0, 0)


# ---------------------------------------------------------------------------
# Fig. 3 panels as SweepSpecs
# ---------------------------------------------------------------------------

def fig3a_spec(rounds: int = 60, seeds=(0, 1), **base_kw) -> List[SweepSpec]:
    """Fig. 3(a): OPT (b=2) vs discard across iid/non-iid/imbalanced
    (distributions stack on the simulation axis)."""
    base = HSFLConfig(rounds=rounds, **base_kw)
    dists = ("iid", "noniid", "imbalanced")
    return [SweepSpec(base=base, seeds=tuple(seeds), distributions=dists,
                      schemes=(("opt", {"b": 2.0}),
                               ("discard", {"b": 1.0})))]


def fig3b_spec(rounds: int = 60, seeds=(0, 1), **base_kw) -> List[SweepSpec]:
    """Fig. 3(b): OPT-HSFL vs Async-HSFL vs discard on non-iid."""
    base = HSFLConfig(rounds=rounds, **base_kw)
    return [SweepSpec(base=base, seeds=tuple(seeds),
                      schemes=(("opt", {"b": 2.0}),
                               ("async", {"b": 1.0}),
                               ("discard", {"b": 1.0})))]


def fig3c_spec(rounds: int = 60, seeds=(0,), **base_kw) -> List[SweepSpec]:
    """Fig. 3(c): the budget sweep, b on the config axis."""
    base = HSFLConfig(rounds=rounds, scheme="opt", **base_kw)
    return [SweepSpec(base=base, seeds=tuple(seeds),
                      b=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0))]


def fig3d_spec(rounds: int = 60, seeds=(0,), **base_kw) -> List[SweepSpec]:
    """Fig. 3(d): the τ_max sweep, the latency cliff on the config axis."""
    base = HSFLConfig(rounds=rounds, scheme="opt", b=2, **base_kw)
    return [SweepSpec(base=base, seeds=tuple(seeds),
                      tau_max=(7.0, 8.0, 9.0, 10.0, 11.0))]
