"""Training launcher: one device, the zoo's synthetic LM pipeline
(``repro/launch/train.py``, with ``--device``).

Picks an arch (full or ``--reduced``), builds the synthetic token stream,
trains with AdamW + a cosine schedule and a global-norm clip of 1.0, and
checkpoints every ``--ckpt-every`` steps.  With ``--ckpt-dir`` holding a
committed save it resumes from the newest one; the batch draws then go
on where the saved run left them (the reference draws them again from
the seed's start), so a resumed run equals an uninterrupted one.

Runs on the CUDA card (``--device cuda``, the default, which raises
without a card) or on the CPU with ``--device cpu``.

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch llama3.2-1b --reduced --steps 100 --batch 8 --seq 128

  # Llama-3.2-1B at full size on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 20 --batch 2 --seq 2048
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import make_token_stream
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine
from repro_torch.training import create_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train a zoo model on the "
                                 "synthetic token stream")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (cuda raises without a card)")
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale variant of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    print(f"arch={cfg.name} reduced={args.reduced} device={model.device} "
          f"layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params~{cfg.param_count()/1e6:.1f}M")

    params = model.init(
        torch.Generator(device=model.device).manual_seed(args.seed))
    opt = adamw(cosine(args.lr, warmup=max(1, args.steps // 10),
                       total=args.steps))
    state = create_train_state(params, opt)

    start = 0
    if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
        state = restore_checkpoint(args.ckpt_dir, s, state)
        start = int(state.step)
        print(f"restored checkpoint at step {start}")

    ds = make_token_stream(args.batch * 64, args.seq,
                           vocab=cfg.vocab_size, seed=args.seed)
    step_fn = make_train_step(model, opt, grad_clip=1.0)
    rng = np.random.default_rng(args.seed)
    for _ in range(start):                   # the draws of the saved steps
        rng.integers(0, len(ds.x), args.batch)

    metrics = None
    t0 = time.time()
    for i in range(start, args.steps):
        take = rng.integers(0, len(ds.x), args.batch)
        batch = {"tokens": torch.tensor(ds.x[take], device=model.device),
                 "labels": torch.tensor(ds.y[take], device=model.device)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.num_patches, cfg.d_model),
                dtype=torch.float32 if cfg.dtype == "float32"
                else torch.bfloat16, device=model.device)
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0 or i == start:
            sps = (i + 1 - start) / (time.time() - t0)
            print(f"step {i+1}/{args.steps} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} ({sps:.2f} steps/s)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, state)
            print(f"saved checkpoint at step {i+1}")
    if metrics is None:
        print(f"done: nothing to train (step {start} of {args.steps})")
    else:
        print(f"done: final loss {float(metrics['loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
