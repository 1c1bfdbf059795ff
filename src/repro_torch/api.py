"""``repro_torch.api``: one ``Experiment`` facade over the HSFL engines
(``repro/api.py``)::

    from repro_torch.api import Experiment

    # one scheme, one seed, the fused round on the card -> SimLog
    log = Experiment(rounds=30).with_scheme("opt", b=2.0).run(engine="fused")

    # a Fig. 3(b) panel on the sweep engine -> SweepResult
    res = (Experiment(rounds=60, distribution="noniid")
           .with_scheme("opt", b=2.0)
           .with_scheme("async", b=1.0)
           .with_scheme("discard", b=1.0)
           .with_seeds(0, 1)
           .run(engine="sweep"))

Engines:

  ``loop``   the host reference loop (``HSFLSimulation`` with
             ``use_fused_round=False``): one ``OppTransmitter`` per user,
             numpy streams.
  ``fused``  the same per-round loop around the fused round
             (``core/fused_round.build_fused_round``).
  ``sweep``  the device engine (``core/sweep``): every (simulation,
             config) row of a group folded into one cohort, rounds in a
             loop that reads nothing back; seeded streams of its own.
  ``auto``   ``sweep``.

``loop``/``fused`` return a ``SimLog`` (a list for several seeds);
``sweep`` a ``SweepResult``.  ``Experiment.serve`` builds the
fault-tolerant aggregation service (``serving/fl_server.FLServer``).

Every engine runs on the CUDA card unless ``run(device="cpu")`` (or
``serve(device="cpu")``) asks for the CPU; without a card it raises.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, List, Tuple, Union

from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
from repro_torch.core.metrics import SimLog
from repro_torch.core.schemes import (Scheme, get_scheme, register_scheme,
                                      registered_schemes)
from repro_torch.core.sweep import (CFG_AXES, GROUP_STATICS, SweepResult,
                                    SweepSpec, _run_sweep)
from repro_torch.device import resolve_device

__all__ = ["ENGINES", "Experiment", "Scheme", "get_scheme",
           "register_scheme", "registered_schemes"]

ENGINES = ("auto", "loop", "fused", "sweep")

# HSFLConfig fields that are int-typed but ride float-valued sweep pins
_INT_PINS = ("b",)


class Experiment:
    """A declarative experiment; every ``with_*`` returns a copy."""

    def __init__(self, cfg: HSFLConfig | None = None, **overrides):
        if cfg is None:
            cfg = HSFLConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        self.cfg = cfg
        self._schemes: List[Scheme] = []
        self._seeds: Tuple[int, ...] = (cfg.seed,)
        self._dists: Tuple[str, ...] = ()
        self._axes: Dict[str, Tuple[float, ...]] = {}
        self._spec_override: SweepSpec | None = None

    @classmethod
    def from_spec(cls, spec: SweepSpec) -> "Experiment":
        """Wrap a ready-made ``SweepSpec`` (``sweep.fig3b_spec`` ...)."""
        ex = cls(spec.base)
        ex._spec_override = spec
        return ex

    def _clone(self) -> "Experiment":
        if self._spec_override is not None:
            raise ValueError(
                "this Experiment wraps a ready-made SweepSpec "
                "(Experiment.from_spec); builder methods would be ignored "
                "— edit the spec, or start from Experiment(cfg)")
        ex = Experiment(self.cfg)
        ex._schemes = list(self._schemes)
        ex._seeds = self._seeds
        ex._dists = self._dists
        ex._axes = dict(self._axes)
        return ex

    # -- with_* ---------------------------------------------------------------
    def with_scheme(self, scheme: Union[str, Scheme],
                    **pins) -> "Experiment":
        """Append a registered scheme (by name or instance); ``pins`` fix
        config-axis values (b, tau_max, bandwidth_ratio) or group statics
        (use_delta_codec, codec_block, codec_bits, kernel, precision, ...)
        for that scheme's group."""
        ex = self._clone()
        ex._schemes.append(get_scheme(scheme).with_pins(**pins))
        return ex

    def with_seeds(self, *seeds: int) -> "Experiment":
        ex = self._clone()
        ex._seeds = tuple(int(s) for s in seeds)
        return ex

    def with_distributions(self, *dists: str) -> "Experiment":
        ex = self._clone()
        ex._dists = tuple(dists)
        return ex

    def with_axes(self, **axes) -> "Experiment":
        """Sweep values on the config axes, e.g. ``with_axes(b=(1.0, 2.0))``
        (sweep engine only)."""
        bad = sorted(set(axes) - set(CFG_AXES))
        if bad:
            raise ValueError(f"{bad} are not traced config axes {CFG_AXES}; "
                             f"pin group statics {GROUP_STATICS} per scheme "
                             f"via with_scheme(..., **pins)")
        ex = self._clone()
        for k, v in axes.items():
            ex._axes[k] = tuple(float(x) for x in v)
        return ex

    # -- spec / config materialization --------------------------------------
    def to_spec(self) -> SweepSpec:
        """The ``SweepSpec`` this experiment runs on the sweep engine."""
        if self._spec_override is not None:
            return self._spec_override
        return SweepSpec(
            base=self.cfg, seeds=self._seeds,
            schemes=tuple(self._schemes),
            distributions=self._dists,
            b=self._axes.get("b", ()),
            tau_max=self._axes.get("tau_max", ()),
            bandwidth_ratio=self._axes.get("bandwidth_ratio", ()))

    def _loop_cfgs(self, engine: str) -> List[HSFLConfig]:
        """Per-simulation configs for the host-driven engines (every pin
        folded into the HSFLConfig)."""
        if self._spec_override is not None:
            raise ValueError("from_spec experiments run on the sweep "
                             "engine; loop/fused take Experiments made "
                             "with with_*")
        if len(self._schemes) > 1:
            raise ValueError(
                f"engine={engine!r} runs one scheme per simulation; got "
                f"{[s.name for s in self._schemes]} — use engine='sweep' "
                f"for multi-scheme panels")
        if len(self._dists) > 1:
            raise ValueError(f"engine={engine!r} runs one distribution; "
                             f"use engine='sweep'")
        cfg = self.cfg
        if self._dists:
            cfg = replace(cfg, distribution=self._dists[0])
        for k, vals in self._axes.items():
            if len(vals) != 1:
                raise ValueError(
                    f"engine={engine!r} cannot sweep {k}={vals}; swept "
                    f"axes need engine='sweep'")
        pins = {k: vals[0] for k, vals in self._axes.items()}
        if self._schemes:
            scheme = self._schemes[0]
            cfg = replace(cfg, scheme=scheme.name)
            pins.update(dict(scheme.pins))
        for k, v in pins.items():
            if k == "bandwidth_ratio":
                if float(v) != 1.0:
                    raise ValueError("bandwidth_ratio is a sweep-engine "
                                     "axis; the host engines run at 1.0")
                continue
            if k in _INT_PINS:
                if float(v) != int(float(v)):
                    raise ValueError(
                        f"{k}={v!r} is fractional: the host engines take "
                        f"integer budgets (the sweep engine traces floats) "
                        f"— pin an integral value or use engine='sweep'")
                v = int(float(v))
            if k in CFG_AXES or k in GROUP_STATICS:
                cfg = replace(cfg, **{k: v})
            else:
                raise ValueError(f"scheme pin {k!r} is neither a traced "
                                 f"axis {CFG_AXES} nor a group static "
                                 f"{GROUP_STATICS}")
        cfg = replace(cfg, use_fused_round=(engine == "fused"))
        return [replace(cfg, seed=sd) for sd in self._seeds]

    # -- execution ----------------------------------------------------------
    def run(self, engine: str = "auto", mesh: Any = "auto",
            verbose: bool = False, device=None, **engine_kw
            ) -> Union[SimLog, List[SimLog], SweepResult]:
        """Run on the chosen engine, on ``device`` (``None``: the card).

        ``engine_kw`` passes through to the sweep engine (``timeit``,
        ``lower_discard``, ``overlap_compile``, ``stream_factory``).
        ``mesh`` applies to the sweep engine only: ``None`` (one device),
        a process group from ``launch.mesh.make_sweep_mesh`` (the
        simulation rows split over its ranks, every rank returning the
        whole result), or ``"auto"`` (the default group when
        ``torch.distributed`` has more than one rank); anything else
        raises a ``TypeError``."""
        if engine == "auto":
            engine = "sweep"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from "
                             f"{ENGINES}")
        device = resolve_device(device)
        if engine == "sweep":
            return _run_sweep(self.to_spec(), mesh=mesh, verbose=verbose,
                              device=device, **engine_kw)
        if engine_kw:
            raise ValueError(f"{sorted(engine_kw)} only apply to the "
                             f"sweep engine")
        logs = [HSFLSimulation(cfg, device=device).run(verbose=verbose)
                for cfg in self._loop_cfgs(engine)]
        return logs[0] if len(logs) == 1 else logs

    def to_config(self) -> HSFLConfig:
        """The single-simulation ``HSFLConfig`` this experiment denotes
        (one scheme, one seed, every pin folded in): what ``serve()``
        consumes."""
        cfgs = self._loop_cfgs("loop")
        if len(cfgs) != 1:
            raise ValueError(f"to_config() denotes one simulation; got "
                             f"{len(cfgs)} seeds — pick one with "
                             f"with_seeds(s)")
        return cfgs[0]

    def serve(self, *, ckpt_dir: str | None = None, faults=None,
              quorum: float = 0.0, device=None, **server_kw):
        """The long-lived aggregation service for this experiment (one
        scheme, one seed): an un-started ``serving.fl_server.FLServer``
        on ``device`` (``None``: the card).  ``faults`` is a ``FaultPlan``
        or plan-grammar string; ``server_kw`` passes through (e.g.
        ``transport=core.transport.TransportConfig(...)``)."""
        from repro_torch.serving.fl_server import FLServer
        return FLServer(self.to_config(), device=device, ckpt_dir=ckpt_dir,
                        fault_plan=faults, quorum=quorum, **server_kw)
