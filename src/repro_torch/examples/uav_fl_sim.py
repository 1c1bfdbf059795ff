"""The paper's full experiment at its native scale, on the port
(``examples/uav_fl_sim.py``).

Reproduces the Fig. 3(b) comparison, OPT-HSFL (b=2) vs Async-HSFL vs
discard, over 30 UAVs with the Rician channel, greedy selection, bursty
interruptions and FedAvg aggregation.

Everything routes through the ``repro_torch.api.Experiment`` facade.  By
default the whole panel runs on the sweep engine (``core/sweep``): every
scheme group's (simulation, config) rows folded into one cohort, rounds
in a loop that reads nothing back.  ``--engine loop`` runs one fused
per-cell simulation per scheme instead (host-presampled channel).
``--schemes`` takes any registered scheme names (``repro_torch.core.
schemes``) as ``name=b`` pairs.  ``--kernel`` picks the CNN hot path
(``kernels/fused_cnn.ForwardPolicy.kernel``): ``xla`` and ``pallas``
both run the port's fused-CNN kernels (the reference's custom-VJP step
and its Pallas suite), ``im2col`` the autograd baseline.

``--serve`` runs the first scheme of the panel through the long-lived
fault-tolerant aggregation service instead (``serving/fl_server``), with
optional fault injection and crash/resume durability::

    PYTHONPATH=src python -m repro_torch.examples.uav_fl_sim --serve \\
        --rounds 10 --faults "dup@r2:c*; crash@r5:close" \\
        --ckpt-dir /tmp/fl_ckpt

Run:  PYTHONPATH=src python -m repro_torch.examples.uav_fl_sim
      [--rounds 100] [--seeds 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import Experiment, registered_schemes

SCHEMES = (("opt", 2), ("async", 1), ("discard", 1))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the Fig. 3(b) comparison")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where it runs (cuda raises without a card)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--distribution", default="noniid",
                    choices=["iid", "noniid", "imbalanced"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (stacked on the sweep's sim axis)")
    ap.add_argument("--engine", default="sweep", choices=["sweep", "loop"])
    ap.add_argument("--schemes", nargs="*", default=None, metavar="NAME=B",
                    help="scheme panel as name=b pairs (default: opt=2 "
                         "async=1 discard=1); registered: "
                         f"{', '.join(registered_schemes())}")
    ap.add_argument("--codec", action="store_true",
                    help="int8 delta-codec snapshots (kernels/delta_codec): "
                         "payloads shrink ~4x and rescues carry quantization "
                         "noise; runs on either engine")
    ap.add_argument("--kernel", default="xla",
                    choices=["xla", "pallas", "im2col"],
                    help="CNN hot path (kernels/fused_cnn.ForwardPolicy): "
                         "xla and pallas both run the fused-CNN kernels, "
                         "im2col the autograd baseline")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                    help="compute precision of the training step (bf16 "
                         "keeps f32 master params and loss)")
    ap.add_argument("--block-k", type=int, default=0,
                    help="user-tile size of the blocked kernel grid "
                         "(0 = whole selected cohort in one grid step; see "
                         "kernels/fused_cnn.ForwardPolicy.block_k)")
    ap.add_argument("--serve", action="store_true",
                    help="run the first scheme through the fault-tolerant "
                         "aggregation service (serving/fl_server) instead "
                         "of the batch engines")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="with --serve: fault plan, e.g. "
                         "'dup@r2:c*; crash@r3:close'")
    ap.add_argument("--ckpt-dir", default=None,
                    help="with --serve: checkpoint/resume directory (crash "
                         "faults require it)")
    ap.add_argument("--quorum", type=float, default=0.0,
                    help="with --serve: hold rounds open for late uploads "
                         "until this fraction of scheduled finals arrived")
    ap.add_argument("--transport", action="store_true",
                    help="with --serve: chunked lossy-wire uploads with "
                         "XOR-parity erasure rescue (core/transport)")
    ap.add_argument("--ber-bad", type=float, default=0.0,
                    help="with --transport: bit-error rate in the wire's "
                         "bad (burst) state")
    ap.add_argument("--parity-k", type=int, default=4,
                    help="with --transport: data chunks per XOR parity group")
    args = ap.parse_args(argv)
    if not args.schemes:
        return args, SCHEMES
    schemes = []
    for kv in args.schemes:
        name, eq, b = kv.partition("=")
        if not eq or not name:
            ap.error(f"--schemes takes NAME=B pairs (e.g. deadline=2), "
                     f"got {kv!r}")
        schemes.append((name, float(b)))
    return args, tuple(schemes)


def serve(args, base, schemes, t0: float) -> int:
    """--serve: the first scheme through the aggregation service."""
    from repro_torch.serving.fl_server import run_with_restarts

    transport = None
    if args.transport:
        from repro_torch.core.transport import TransportConfig
        transport = TransportConfig(parity_k=args.parity_k,
                                    ber_bad=args.ber_bad)
    scheme, b = schemes[0]
    ex = base.with_seeds(args.seed).with_scheme(scheme, b=float(b))
    print(f"--- serving {scheme} (b={b}) on {args.distribution}"
          + (f", faults: {args.faults}" if args.faults else "") + " ---")
    if args.ckpt_dir:
        server, restarts = run_with_restarts(
            ex.to_config(), ckpt_dir=args.ckpt_dir, fault_plan=args.faults,
            quorum=args.quorum, transport=transport, verbose=True,
            device=args.device)
    else:
        server = ex.serve(faults=args.faults, quorum=args.quorum,
                          transport=transport, device=args.device)
        server.serve(verbose=True)
        restarts = 0
    s = server.log.summary()
    print(f"\n=== served {scheme}: final={s['final_acc']:.4f} "
          f"comm={s['avg_comm_mb']:.1f} MB/round "
          f"rescued={s['snapshot_rescues']} dropped={s['drops']} "
          f"dup_rejected={s['duplicates_rejected']} "
          f"corrupt_rejected={s['corrupt_rejected']} "
          f"retries={s['retries']} restarts={restarts} "
          f"({time.time() - t0:.1f}s) ===")
    if server.metrics_path:
        print(f"metrics log: {server.metrics_path}")
    return 0


def main(argv=None) -> int:
    args, schemes = parse_args(argv)
    seed_list = tuple(args.seed + i for i in range(args.seeds))
    t0 = time.time()
    base = Experiment(rounds=args.rounds, distribution=args.distribution,
                      use_delta_codec=args.codec, kernel=args.kernel,
                      precision=args.precision,
                      block_k=args.block_k).with_seeds(*seed_list)
    if args.serve:
        return serve(args, base, schemes, t0)

    results = {}
    if args.engine == "sweep":
        ex = base
        for s, b in schemes:
            ex = ex.with_scheme(s, b=float(b))
        res = ex.run(engine="sweep", verbose=True, device=args.device)
        if args.codec:
            print(f"[codec] panel ran as {res.n_programs} programs "
                  f"(discard lowered onto opt@b=1)")
        for g in res.groups:
            # seed 0's trajectory represents the scheme (summary averages seeds)
            results[g.scheme] = [g.sim_log(i, 0) for i in range(len(g.sims))]
    else:
        for scheme, b in schemes:
            print(f"--- {scheme} (b={b}) on {args.distribution} ---")
            logs = base.with_scheme(scheme, b=float(b)).run(
                engine="fused", verbose=True, device=args.device)
            results[scheme] = logs if isinstance(logs, list) else [logs]

    wall = time.time() - t0
    print(f"\n=== summary (Fig. 3b, {args.engine} engine, "
          f"{len(seed_list)} seed(s), {wall:.1f}s) ===")
    finals = {}
    for scheme, logs in results.items():
        s = [log.summary() for log in logs]
        accs = np.stack([[a for a in log.acc_curve if a == a] for log in logs])
        finals[scheme] = float(np.mean([x["final_acc"] for x in s]))
        print(f"{scheme:8s}: final={finals[scheme]:.4f} "
              f"tail_std={np.std(accs[:, -10:], axis=1).mean():.4f} "
              f"comm={np.mean([x['avg_comm_mb'] for x in s]):.1f} MB/round "
              f"rescued={sum(x['snapshot_rescues'] for x in s)} "
              f"dropped={sum(x['drops'] for x in s)}")
    if "opt" in finals and "async" in finals:
        print(f"\nOPT - Async accuracy delta: "
              f"{100 * (finals['opt'] - finals['async']):+.2f} pp "
              f"(paper: +3.98 pp at 100 rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
