"""OpportunisticSync across pods, on the port
(``examples/opportunistic_multipod.py``).

Four ranks stand in for four pods (``launch.mesh.spawn_ranks``; on one
card they share it through gloo, see ``launch/mesh.py``).  Each pod runs
local SGD on its shard of a token stream; at scheduled inner steps it
snapshots its params when the simulated cross-pod link is good (eqs.
14-16); at the round boundary a pod whose final update was lost
contributes its snapshot instead (a masked mean over the pods).

Run:  PYTHONPATH=src python -m repro_torch.examples.opportunistic_multipod
      [--rounds 6] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.opportunistic_sync import (OppSyncConfig, channel_trace,
                                                 make_opp_sync_round)
from repro_torch.data import make_token_stream
from repro_torch.launch.mesh import make_pod_group, spawn_ranks
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.training import create_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves

N_PODS, ROUNDS = 4, 6
B, S = 4, 32
CFG = OppSyncConfig(inner_steps=6, budget=2, outage_prob=0.3, rate0=1.0)


def _pod(rank: int, world: int, device: torch.device, rounds: int):
    """One pod's rounds; rank 0 returns the lines to print."""
    e = CFG.inner_steps
    model = build_model(get_config("llama3.2-1b").reduced(), device)
    # a CPU generator: the same weights on every rank, whatever its device
    params = model.init(torch.Generator().manual_seed(0))
    opt = sgd(5e-2)
    state = create_train_state(params, opt, with_opt_sync=True,
                               tau_extra0=CFG.tau_extra0)
    one_round = make_opp_sync_round(CFG, make_train_step(model, opt),
                                    make_pod_group())
    ds = make_token_stream(world * e * B * rounds, S,
                           vocab=model.cfg.vocab_size, seed=0)
    rates, outages, arrived = channel_trace(
        CFG, torch.Generator().manual_seed(7), world, rounds)
    lines = []
    for r in range(rounds):
        lo = r * world * e * B
        batches = {k: torch.tensor(
            a[lo:lo + world * e * B].reshape(world, e, B, S)[rank],
            device=device) for k, a in (("tokens", ds.x), ("labels", ds.y))}
        state, losses = one_round(state, batches, rates[r], outages[r],
                                  arrived[r])
        total = losses.sum().reshape(1)
        dist.all_reduce(total)
        lines.append(f"round {r + 1}: mean inner loss "
                     f"{float(total) / (world * e):.4f}  "
                     f"arrived={arrived[r].tolist()}")
    # every pod ends the round with the same (aggregated) params
    for leaf in tree_leaves(state.params):
        ref = leaf.clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(leaf, ref):
            raise AssertionError(f"pod {rank}'s params differ from pod 0's")
    return lines if rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks run (cuda raises without a card)")
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else "cpu"
    lines = spawn_ranks(_pod, N_PODS, device, args=(args.rounds,))[0]
    print("\n".join(lines))
    print("pods converged to a common aggregate — OpportunisticSync OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
