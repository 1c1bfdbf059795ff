"""FL aggregation service launcher: the long-lived serving path
(``repro/launch/serve_fl.py``, with ``--device``).

Runs ``serving/fl_server.FLServer`` under a restart supervisor: injected
(or real) crashes resume from the latest committed msgpack checkpoint and
training continues bit for bit.  It runs on the CUDA card (``--device
cuda``, the default, which raises without a card) or on the CPU with
``--device cpu``.

  # int8 delta-codec snapshots, checkpointing every round
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --rounds 20 \
      --scheme opt --codec --ckpt-dir fl_ckpt

  # chaos: duplicates + corruption + a mid-training server kill
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --rounds 10 \
      --codec --ckpt-dir fl_ckpt \
      --faults "dup@r2:c*; corrupt@r3:c*; crash@r5:checkpoint"

  # a small run on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --device cpu \
      --rounds 2 --n-train 400 --n-test 100 --codec

Re-running with the same ``--ckpt-dir`` resumes from the latest committed
round (pass ``--fresh`` to wipe and start over).  Per-round metrics append
to ``<ckpt-dir>/metrics.jsonl``.
"""
from __future__ import annotations

import argparse
import os
import shutil

from repro_torch.core.faults import FaultPlan
from repro_torch.core.hsfl import HSFLConfig
from repro_torch.core.schemes import registered_schemes
from repro_torch.core.transport import TransportConfig
from repro_torch.serving.fl_server import FLServer, run_with_restarts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="long-lived fault-tolerant FL aggregation service")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the server runs (cuda raises without a "
                         "card)")
    ap.add_argument("--scheme", default="opt", choices=registered_schemes())
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distribution", default="noniid",
                    choices=["iid", "noniid", "imbalanced"])
    ap.add_argument("--n-uavs", type=int, default=30)
    ap.add_argument("--k-select", type=int, default=10)
    ap.add_argument("--n-train", type=int, default=None,
                    help="shrink the train split (smoke runs)")
    ap.add_argument("--n-test", type=int, default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--local-epochs", type=int, default=None)
    ap.add_argument("--codec", action="store_true",
                    help="int8 delta-codec snapshots")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume directory (also holds "
                         "metrics.jsonl); omit to run without durability")
    ap.add_argument("--fresh", action="store_true",
                    help="wipe --ckpt-dir before serving")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="fault plan, e.g. 'dup@r2:c*; crash@r3:close' "
                         "(kinds: drop dup corrupt delay crash flip "
                         "partial)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="seeded random fault plan instead of --faults")
    ap.add_argument("--chaos-dup", type=float, default=0.05)
    ap.add_argument("--chaos-corrupt", type=float, default=0.05)
    ap.add_argument("--chaos-drop", type=float, default=0.0)
    ap.add_argument("--chaos-delay", type=float, default=0.0)
    ap.add_argument("--chaos-flip", type=float, default=0.0,
                    help="per-(round,client) prob of CRC-clean bit flips")
    ap.add_argument("--chaos-partial", type=float, default=0.0,
                    help="per-(round,client) prob of a truncated upload")
    tr = ap.add_argument_group(
        "lossy-wire transport (opt-in chunked uploads; see core/transport)")
    tr.add_argument("--transport", action="store_true",
                    help="chunked resumable uploads + XOR-parity erasure "
                         "rescue over a Gilbert-Elliott burst-error wire")
    tr.add_argument("--chunk-bytes", type=int, default=4096)
    tr.add_argument("--parity-k", type=int, default=4,
                    help="data chunks per XOR parity group (0 = no parity)")
    tr.add_argument("--ber-good", type=float, default=0.0,
                    help="wire bit-error rate in the good channel state")
    tr.add_argument("--ber-bad", type=float, default=0.0,
                    help="wire bit-error rate in the bad (burst) state")
    tr.add_argument("--wire-outage", type=float, default=0.30,
                    help="stationary bad-state probability of the wire")
    tr.add_argument("--wire-persistence", type=float, default=0.70,
                    help="bad-state persistence of the wire")
    ap.add_argument("--quorum", type=float, default=0.0,
                    help="hold the round open for late uploads until this "
                         "fraction of scheduled finals arrived")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--metrics-path", default=None,
                    help="per-round JSONL log (default: "
                         "<ckpt-dir>/metrics.jsonl)")
    ap.add_argument("--no-tuned-env", action="store_true",
                    help="accepted for the reference's command lines and "
                         "ignored: the tuned environment sets XLA flags, "
                         "which have no PyTorch counterpart")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.faults and args.chaos_seed is not None:
        ap.error("--faults and --chaos-seed are mutually exclusive")
    plan = FaultPlan.parse(args.faults) if args.faults else None
    if args.chaos_seed is not None:
        plan = FaultPlan.random(
            args.chaos_seed, args.rounds, range(args.n_uavs),
            p_dup=args.chaos_dup, p_corrupt=args.chaos_corrupt,
            p_drop=args.chaos_drop, p_delay=args.chaos_delay,
            p_flip=args.chaos_flip, p_partial=args.chaos_partial)
    transport = None
    if args.transport:
        transport = TransportConfig(
            chunk_bytes=args.chunk_bytes, parity_k=args.parity_k,
            ber_good=args.ber_good, ber_bad=args.ber_bad,
            wire_outage_prob=args.wire_outage,
            wire_persistence=args.wire_persistence)
    if args.fresh and args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)

    small = {k: getattr(args, k) for k in
             ("n_train", "n_test", "steps_per_epoch", "local_epochs")
             if getattr(args, k) is not None}
    cfg = HSFLConfig(scheme=args.scheme, b=args.b, rounds=args.rounds,
                     seed=args.seed, distribution=args.distribution,
                     n_uavs=args.n_uavs, k_select=args.k_select,
                     use_delta_codec=args.codec, **small)
    verbose = not args.quiet
    if plan and verbose:
        print(f"[serve_fl] fault plan: {plan}")
    if args.ckpt_dir:
        server, restarts = run_with_restarts(
            cfg, ckpt_dir=args.ckpt_dir, fault_plan=plan,
            max_restarts=args.max_restarts, quorum=args.quorum,
            eval_every=args.eval_every, metrics_path=args.metrics_path,
            transport=transport, verbose=verbose, device=args.device)
    else:
        server = FLServer(cfg, device=args.device, fault_plan=plan,
                          quorum=args.quorum,
                          eval_every=args.eval_every,
                          metrics_path=args.metrics_path,
                          transport=transport)
        server.serve(verbose=verbose)
        restarts = 0

    s = server.log.summary()
    print(f"[serve_fl] scheme={args.scheme} rounds={s['rounds']} "
          f"final_acc={s['final_acc']:.4f} "
          f"comm={s['avg_comm_mb']:.1f} MB/round "
          f"rescued={s['snapshot_rescues']} drops={s['drops']} "
          f"dup_rejected={s['duplicates_rejected']} "
          f"stale_rejected={s['stale_rejected']} "
          f"corrupt_rejected={s['corrupt_rejected']} "
          f"retries={s['retries']} restarts={restarts}")
    if transport is not None:
        print(f"[serve_fl] transport: chunks={s['chunks_sent']} "
              f"retransmitted={s['chunks_retransmitted']} "
              f"parity_recovered={s['chunks_recovered']} "
              f"transfers_lost={s['transfers_incomplete']}")
    if server.metrics_path:
        print(f"[serve_fl] metrics log: {server.metrics_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
