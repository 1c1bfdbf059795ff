"""Serving launcher: batched autoregressive generation
(``repro/launch/serve.py``, with ``--device``).

Runs on the CUDA card (``--device cuda``, the default, which raises
without a card) or on the CPU with ``--device cpu``.  Weights are random,
drawn from ``--seed`` on the run's device.  ``--arch`` takes every arch of
the zoo; the prompt is text tokens (qwen2-vl-2b's too), and an
encoder-only arch (hubert-xlarge) prints that it has no autoregressive
serving.

  # Llama-3.2-1B at full size on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 64 --max-new 32

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch rwkv6-7b --reduced --batch 4 --prompt-len 16 --max-new 32

  # Hymba-1.5B (attention beside mamba) at full size on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.serving import generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="batched autoregressive "
                                 "generation from a zoo model")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cuda raises without a card)")
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    if model.decode is None:
        print(f"{cfg.name} is encoder-only: no autoregressive serving")
        return 0

    params = model.init(
        torch.Generator(device=model.device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompt = torch.tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=model.device)
    ctx = args.prompt_len + args.max_new

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    sync()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, max_new=args.max_new,
                   context_len=ctx, temperature=args.temperature,
                   gen=torch.Generator(device=model.device).manual_seed(
                       args.seed))
    sync()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.max_new
    print(f"arch={cfg.name} device={model.device} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}")
    print(f"generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, prompt fed token by token)")
    for b in range(min(2, args.batch)):
        print(f"  request {b}: {out[b].cpu().tolist()[:16]} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
