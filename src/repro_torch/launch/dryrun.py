"""Multi-pod dry run: lay out every (architecture x input shape) on the
production meshes and count what one rank of it costs
(``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --out dry.jsonl
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k \\
        --both-meshes --device cpu

Where the reference lowers and compiles each program for 256 or 512
placeholder devices, the port runs it: in a fake world of 256 or 512
ranks (``launch.mesh.fake_world``: this process is rank 0, collectives do
nothing), on the production ``DeviceMesh`` (``make_production_mesh``),
with every param, optimizer, input and decode-state leaf a ``DTensor``
placed by ``sharding/rules.py``'s specs, under ``FakeTensorMode`` (shapes
and dtypes, no memory, no data).  ``utils.op_stats.ProgramStats`` counts
rank 0's local ops as they run: FLOPs, HBM bytes, collectives by kind,
and argument, output, temp and peak bytes of live storage.  Each record
then gets the three roofline terms at one H100 SXM5's datasheet rates
(``launch/mesh.py``).

The programs are the reference's ``impl="xla"`` programs: on DTensors the
model bodies take their einsum paths (``models/transformer.py``), and no
kernel wrapper sees a DTensor or a fake tensor.  Tensors the bodies make
themselves (rope angles, masks, positions) join the sharded ones as
replicated DTensors: every program runs under ``implicit_replication``.

- train: ``make_train_step`` with AdamW (bf16 moments under ``--tuned``,
  read here from ``adam_bf16_moments``, which never reaches the model's
  opts), remat (``full`` by default), and a global-norm clip of 1.0, the
  clip of the port's launcher and of ``chip_smoke.py``'s phase 10 step;
  the new state is laid out as the old one;
- prefill: ``make_prefill_step``, its logits laid out by ``logits_spec``;
- decode: one token against a ``seq_len``-deep cache, the state in and
  out laid out by ``decode_state_specs``.

The recurrences run as Python loops over S on DTensors (4096 fake steps
a layer to train at 4k, and again in the backward), so ``measure`` counts
each at two short lengths and extends it affinely in S, forward and
backward (``utils.op_stats.recurrence``): the rest of the program runs at
full S, and the recurrence's outputs keep their true shapes, placements
and live bytes.  The tests hold the extended counts equal to the full
loop's at a short S.

``calibrate`` keeps the reference's affine pair: the program at 1 and 2
layers, extrapolated as X(L) = X(1) + (L-1)·(X(2) - X(1)) for the FLOPs,
bytes and collective bytes.  In eager torch the full program's own counts
are exact too (the record keeps them under ``full_depth``); the tests
hold the two equal.  The record's ``lower_compile_s`` and
``total_compile_s`` are the seconds spent running the fake program(s).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      ModelConfig, get_config, tuned_opts)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     fake_world, make_production_mesh)
from repro_torch.models import inputs as model_inputs
from repro_torch.models import transformer as tf
from repro_torch.models.registry import abstract_init, build_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.apply import distribute_tree
from repro_torch.training import (create_train_state, make_decode_step,
                                  make_prefill_step, make_train_step)
from repro_torch.utils.op_stats import ProgramStats
from repro_torch.utils.tree import tree_map

DRYRUN_OPTS = {"impl": "xla", "moe_dispatch": "scatter", "remat": "none"}
DRYRUN_LR = 1e-4
GRAD_CLIP = 1.0
# keys of the dry run's opts that the program reads, not the model
PROGRAM_KEYS = ("adam_bf16_moments",)


def make_opts(shape_kind: str, multi_pod: bool, moe_dispatch: str = "scatter",
              remat: str = "full") -> dict:
    """Dry-run model options: activation sharding map + production remat."""
    return {
        "impl": "xla",
        "moe_dispatch": moe_dispatch,
        # per-layer remat is the production default for training;
        # forward-only programs have no backward pass to rematerialize
        "remat": remat if shape_kind == "train" else "none",
        "act_sharding": {
            "batch": ("pod", "data") if multi_pod else ("data",),
            "model": "model",
            "model_size": 16,
            "batch_size": (2 if multi_pod else 1) * 16,
        },
    }


def adapt_config(arch: str, shape_name: str,
                 overrides: Optional[dict] = None) -> Optional[ModelConfig]:
    """Resolve the (arch, shape) pair; None = documented skip."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "decode" and cfg.is_encoder_only:
        return None                               # hubert: no decode
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        cfg = cfg.with_sliding_window(8192)       # dense long-ctx variant
    # dry-run numerics policy: bf16 storage + f32 AdamW moments
    cfg = cfg.replace(param_dtype="bfloat16", dtype="bfloat16")
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _empty_like_meta(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def abstract_args(cfg: ModelConfig, shape: InputShape, opts: dict,
                  device) -> tuple:
    """The program's arguments at their global shapes, as empty tensors on
    ``device`` (fake ones under ``FakeTensorMode``): the train state and
    batch, the params and prompt, or the params, token, decode state and
    position."""
    params = tree_map(lambda t: _empty_like_meta(t, device),
                      abstract_init(cfg))
    spec = model_inputs.input_specs(cfg, shape)
    batch = {k: torch.zeros(s, dtype=dt, device=device)
             for k, (s, dt) in spec.items()}
    if shape.kind == "train":
        return create_train_state(params, optimizer(opts)), batch
    if shape.kind == "prefill":
        return params, batch
    state = tf.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 torch.bfloat16, device)
    return params, batch["token"], state, batch["position"]


def optimizer(opts: dict):
    return adamw(DRYRUN_LR, moment_dtype=torch.bfloat16
                 if opts.get("adam_bf16_moments") else torch.float32)


def arg_specs(cfg: ModelConfig, shape: InputShape, multi_pod: bool,
              params: Any) -> tuple:
    """Spec trees matching ``abstract_args``' structure."""
    ps = rules.param_specs(cfg, params)
    ins = rules.input_sharding_specs(cfg, shape, multi_pod)
    if shape.kind == "train":
        return rules.train_state_specs(cfg, params), ins
    if shape.kind == "prefill":
        return ps, ins
    return (ps, ins["token"],
            rules.decode_state_specs(cfg, shape.global_batch, multi_pod),
            ins["position"])


def build_program(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
                  opts: Optional[dict] = None, device=None, args=None):
    """Returns ``(fn, args)``: the program and its arguments placed on
    ``mesh`` as DTensors, ready to run as ``fn(*args)``.

    ``args`` defaults to ``abstract_args`` (call this under
    ``FakeTensorMode`` to hold no memory); real trees of the same
    structure (from ``Model.init`` and ``models.inputs.materialize``) may
    be given instead, every rank holding the same ones."""
    from torch.distributed.tensor.experimental import implicit_replication

    dev = resolve_device(device)
    opts = {**DRYRUN_OPTS, **(opts or {})}
    model_opts = {k: v for k, v in opts.items() if k not in PROGRAM_KEYS}
    model = build_model(cfg, dev)
    if args is None:
        args = abstract_args(cfg, shape, opts, dev)
    params = args[0].params if shape.kind == "train" else args[0]
    specs = arg_specs(cfg, shape, multi_pod, params)
    placed = tuple(distribute_tree(mesh, a, s) for a, s in zip(args, specs))

    def out_layout(tree, spec_tree):
        return tree_map(lambda t, s: t.redistribute(
            mesh, rules.placements(mesh, s)), tree, spec_tree)

    if shape.kind == "train":
        step = make_train_step(model, optimizer(opts), model_opts,
                               grad_clip=GRAD_CLIP)

        def fn(state, batch):
            with implicit_replication():
                new, metrics = step(state, batch)
                return out_layout(new, specs[0]), metrics
    elif shape.kind == "prefill":
        step = make_prefill_step(model, model_opts)
        lspec = rules.logits_spec(multi_pod, shape.global_batch)

        def fn(params, batch):
            with implicit_replication():
                return out_layout(step(params, batch), lspec)
    else:
        step = make_decode_step(model, model_opts)

        def fn(params, token, state, position):
            with implicit_replication():
                logits, new = step(params, token, state, position)
                return logits, out_layout(new, specs[2])
    return fn, placed


def measure(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
            opts: Optional[dict] = None, device=None,
            full_loops: bool = False) -> Dict[str, Any]:
    """Run one program on fake tensors over ``mesh`` and return rank 0's
    ``ProgramStats`` record and its seconds.  The recurrences (the WKV
    scan, mamba's selective scan) are counted at two short lengths and
    extended in S (``utils.op_stats.recurrence``), unless ``full_loops``
    runs them step by step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_program(cfg, shape, mesh, multi_pod, opts, device)
        with ProgramStats(hold=args, extrapolate=not full_loops) as stats:
            out = fn(*args)
            stats.outputs(out)
        del out, args
    rec = stats.record()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def roofline_terms(cfg: ModelConfig, shape: InputShape, flops: float,
                   hbm_bytes: float, coll_bytes: float,
                   n_chips: int) -> Dict[str, float]:
    """The three roofline terms of a program over ``n_chips`` H100s: its
    total FLOPs at the bf16 peak, its total HBM bytes at HBM3's rate and
    its total collective bytes at one NDR port's rate, each shared by the
    chips; the dominant one; and the useful ratio, the model's FLOPs
    (6·N·D to train, 2·N·D forward) over the counted ones."""
    compute_s = flops / (n_chips * PEAK_FLOPS_BF16)
    memory_s = hbm_bytes / (n_chips * HBM_BW)
    collective_s = coll_bytes / (n_chips * LINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["dominant"] = max(terms, key=terms.get)
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else
                                   (shape.seq_len if shape.kind == "prefill"
                                    else 1))
    mult = 6 if shape.kind == "train" else 2
    terms["model_flops"] = mult * n_active * tokens
    terms["useful_ratio"] = terms["model_flops"] / max(flops, 1.0)
    return terms


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch: str, shape_name: str, multi_pod: bool,
            opts: Optional[dict] = None, cfg_overrides: Optional[dict] = None,
            verbose: bool = True, calibrate: bool = True,
            device=None) -> Dict[str, Any]:
    """Dry-run one (arch, shape, mesh) triple in a fake world of its own.

    The full program gives the memory record and exact counts; with
    ``calibrate``, the 1- and 2-layer programs give the per-layer deltas
    and the reference's extrapolated FLOPs, bytes and collective bytes,
    and the roofline terms.  A failure is a record with ``status`` "fail"
    (the error and its traceback), never a swallowed exception."""
    dev = resolve_device(device)
    cfg = adapt_config(arch, shape_name, cfg_overrides)
    shape = INPUT_SHAPES[shape_name]
    if cfg is None:
        if verbose:
            print(f"SKIP {arch} x {shape_name} (documented: encoder-only)",
                  flush=True)
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip_documented"}
    n_chips = 512 if multi_pod else 256
    base_opts = make_opts(shape.kind, multi_pod,
                          (opts or {}).get("moe_dispatch", "scatter"),
                          (opts or {}).get("remat", "full"))
    for k, v in (opts or {}).items():     # extra knobs pass through
        if k not in ("moe_dispatch", "remat"):
            base_opts[k] = v
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "multi_pod": multi_pod, "n_chips": n_chips,
                           "device": dev.type,
                           "opts": {k: v for k, v in base_opts.items()
                                    if k != "act_sharding"},
                           "overrides": cfg_overrides or {}}
    t0 = time.perf_counter()
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
            full = measure(cfg, shape, mesh, multi_pod, base_opts, dev)
            rec["lower_compile_s"] = round(full["seconds"], 1)
            rec["memory"] = full["memory"]
            rec["collectives"] = full["collectives"]
            rec["bytes_per_device"] = full["memory"]["peak_memory_in_bytes"]
            rec["full_depth"] = {k: full[k] for k in
                                 ("flops", "bytes", "coll_bytes")}
            if calibrate:
                s1 = measure(cfg.replace(num_layers=1), shape, mesh,
                             multi_pod, base_opts, dev)
                s2 = measure(cfg.replace(num_layers=2), shape, mesh,
                             multi_pod, base_opts, dev)
        rec["total_compile_s"] = round(time.perf_counter() - t0, 1)
        rec["status"] = "ok"
        if not calibrate:
            if verbose:
                print(f"OK {arch} x {shape_name} mesh={_mesh_name(multi_pod)} "
                      f"run={rec['lower_compile_s']}s mem/dev="
                      f"{rec['bytes_per_device'] / 2**30:.2f}GiB "
                      f"(layout proof only)", flush=True)
            return rec
        L = cfg.num_layers

        def extrap(key):
            a, b = s1[key], s2[key]
            return max(a + (L - 1) * (b - a), 0.0)

        flops, hbm, coll = extrap("flops"), extrap("bytes"), \
            extrap("coll_bytes")
        rec["per_layer"] = {k: s2[k] - s1[k]
                            for k in ("flops", "bytes", "coll_bytes")}
        rec["hlo_flops_per_device"] = flops
        rec["hlo_bytes_per_device"] = hbm
        rec["coll_bytes_per_device"] = coll
        rec["roofline"] = roofline_terms(cfg, shape, flops * n_chips,
                                         hbm * n_chips, coll * n_chips,
                                         n_chips)
        if verbose:
            r = rec["roofline"]
            print(f"OK {arch} x {shape_name} mesh={_mesh_name(multi_pod)} "
                  f"run={rec['total_compile_s']}s "
                  f"mem/dev={rec['bytes_per_device'] / 2**30:.2f}GiB "
                  f"compute={r['compute_s'] * 1e3:.2f}ms "
                  f"mem={r['memory_s'] * 1e3:.2f}ms "
                  f"coll={r['collective_s'] * 1e3:.2f}ms "
                  f"dom={r['dominant']} useful={r['useful_ratio']:.2f}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 - a failure here is a finding
        rec["status"] = "fail"
        rec["total_compile_s"] = round(time.perf_counter() - t0, 1)
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"FAIL {arch} x {shape_name} mesh="
                  f"{_mesh_name(multi_pod)}: {rec['error']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--moe-dispatch", default="scatter",
                    choices=["scatter", "dense"])
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--no-calibrate", action="store_true",
                    help="layout and memory proof only")
    ap.add_argument("--tuned", action="store_true",
                    help="per-arch production opts (configs.base.tuned_opts)")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors and the mesh "
                         "(default: the card; 'cpu' runs without one)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    pairs = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    failures = 0
    for a, s, mp in pairs:
        opts = {"moe_dispatch": args.moe_dispatch, "remat": args.remat}
        if args.tuned:
            opts.update(tuned_opts(get_config(a), INPUT_SHAPES[s].kind))
        rec = run_one(a, s, mp, opts, calibrate=not args.no_calibrate,
                      device=args.device)
        failures += rec.get("status") == "fail"
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"done: {len(pairs)} programs, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
