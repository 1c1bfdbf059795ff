"""Batched serving on the port (``examples/serve_batched.py``): prefill +
decode with per-family state.

Serves three architecture families (dense KV cache, attention-free RWKV6
state, hybrid attention+mamba) through the same public API.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where it runs (cuda raises without a card)")
    args = ap.parse_args(argv)

    for arch in ("llama3.2-1b", "rwkv6-7b", "hymba-1.5b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, args.device)
        params = model.init(
            torch.Generator(device=model.device).manual_seed(0))
        rng = np.random.default_rng(0)
        prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 12)),
                              dtype=torch.int32, device=model.device)
        t0 = time.time()
        out = generate(model, params, prompt, max_new=16, context_len=32)
        first = out[0].cpu().tolist()[:8]           # waits for the device
        print(f"{arch:12s} [{cfg.family:6s}] 4 requests x 16 tokens "
              f"in {time.time()-t0:.2f}s -> {first}...")
    print("batched serving OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
