"""Quickstart on the port (``examples/quickstart.py``).

1. A few rounds of OPT-HSFL vs the discard baseline on non-iid data
   through the ``repro_torch.api.Experiment`` facade (the fused round).
2. A reduced hymba-1.5b (attention beside mamba) trained for a handful of
   steps through the public training API.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import Experiment, registered_schemes
from repro_torch.configs import get_config
from repro_torch.data import make_token_stream
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.training import create_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where it runs (cuda raises without a card)")
    args = ap.parse_args(argv)

    # --- 1. the paper: opportunistic-proactive transmission -----------------
    print("== OPT-HSFL (the paper) vs discard, 5 rounds, non-iid ==")
    print(f"   registered schemes: {', '.join(registered_schemes())}")
    for scheme, b in (("opt", 2.0), ("discard", 1.0)):
        log = (Experiment(rounds=5, n_uavs=12, k_select=4, n_train=1200,
                          n_test=300, steps_per_epoch=2, seed=0)
               .with_scheme(scheme, b=b)
               .run(engine="fused", device=args.device))
        s = log.summary()
        print(f"  {scheme:8s} b={int(b)}: acc={s['final_acc']:.3f} "
              f"comm={s['avg_comm_mb']:.1f} MB/round "
              f"rescued={s['snapshot_rescues']} dropped={s['drops']}")

    # --- 2. the framework: any arch of the zoo via one config id ------------
    print("== reduced hymba-1.5b (hybrid attn+mamba), 5 train steps ==")
    cfg = get_config("hymba-1.5b").reduced()
    model = build_model(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    opt = sgd(5e-2)
    state = create_train_state(params, opt)
    step = make_train_step(model, opt)
    ds = make_token_stream(8, 32, vocab=cfg.vocab_size)
    batch = {"tokens": torch.tensor(ds.x[:4], device=model.device),
             "labels": torch.tensor(ds.y[:4], device=model.device)}
    for i in range(5):
        state, metrics = step(state, batch)
        print(f"  step {i+1}: loss={float(metrics['loss']):.4f}")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
