"""Time the fc backward and flash-attention kernels of one source tree, on
one card, so that two trees can be compared in one run.

    python3 scripts/kernel_ab.py [--src DIR] [--label NAME]
                                 [--out FILE] [--against FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds that tree's fused-CNN and flash-attention kernels (into the tree's
own ``build/kernels``), and prints the device time per call
(torch.profiler, device events only; ``chip_smoke.device_split``), split
by ``__global__`` function, of

- ``fc_chain_bwd_k`` at the fused round's shape (K=10 users, batch 10) at
  f32 and bf16, and the single-user ``fc_chain_bwd`` over the same 10
  users (one training step);
- ``flash_attention_bh`` at Llama-3.2-1B's prefill shape (B=2, S=2048, 32
  q / 8 kv heads, D=64, causal) at bf16 and f32, with its TFLOP/s.

The inputs come from fixed seeds.  ``--out`` saves the outputs; with
``--against`` the outputs are compared with a saved file: bitwise for the
fc backward, the largest difference for attention.  To compare two trees
on one card, run them in turns in one command: A, B, B, A.  Needs a CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fc_case(cs, dt):
    """The main path's fc backward inputs: the twins' forward of the
    paper's cohort (K=10, batch 10) in dtype ``dt``."""
    import torch
    from repro_torch.kernels.fused_cnn import ref
    params, x, y = cs.make_case(10, 10, 0, "cuda")
    params, x = cs._cast(params, dt), x.to(dt)
    a1, _ = ref.conv_pool_fwd_k(x, params["conv1"]["w"], params["conv1"]["b"])
    a2, _ = ref.conv_pool_fwd_k(a1, params["conv2"]["w"],
                                params["conv2"]["b"])
    flat = a2.reshape(10, 10, -1)
    logits, res = ref.fc_chain_fwd_k(flat, params)
    g = ((torch.softmax(logits.float(), -1)
          - torch.nn.functional.one_hot(y, 10).float()) / 10).to(dt)
    return flat, res, params, g


def report(label: str, what: str, split: dict, cs, flops: float = 0.0):
    total = sum(split.values())
    parts = ", ".join(f"{cs.short_name(n)} {ms * 1e3:.2f}"
                      for n, ms in split.items())
    rate = f"; {flops / total / 1e9:.1f} TFLOP/s" if flops else ""
    print(f"[{label}] {what}: {total * 1e3:.2f} us per call ({parts}){rate}",
          flush=True)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="save the outputs here (torch.save)")
    ap.add_argument("--against", help="compare the outputs with this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_cnn import kernel as fk
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build_all(["fused_cnn", "flash_attention"])
    print(f"[{args.label}] {cs.card_line()}; kernels of "
          f"{os.path.dirname(_build.__file__)}; built "
          + ", ".join(f"{n} {s:.1f} s" for n, s in built.items()), flush=True)
    outs = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        flat, res, params, g = fc_case(cs, dt)
        grads, dflat = fk.fc_chain_bwd_k(flat, res, params, g)
        outs[f"fc_chain_bwd_k {tag}"] = [dflat] + [
            grads[n][leaf] for n in ("fc1", "fc2", "fc3")
            for leaf in ("w", "b")]
        report(args.label, f"fc_chain_bwd_k {tag} K=10 B=10",
               cs.device_split(lambda: fk.fc_chain_bwd_k(flat, res, params,
                                                          g), 50), cs)
        users = [(flat[i], tuple(r[i] for r in res),
                  {s: {n: t[i] for n, t in params[s].items()}
                   for s in params}, g[i]) for i in range(10)]

        def single():
            for f_, r_, p_, g_ in users:
                fk.fc_chain_bwd(f_, r_, p_, g_)
        report(args.label, f"fc_chain_bwd {tag} x 10 users (one step)",
               cs.device_split(single, 10), cs)
    flops = 4.0 * 64 * (2048 * 2049 // 2) * 2 * 32   # causal q.k and p.v
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = cs.flash_inputs(2, 32, 8, 2048, 2048, 64, dt, seed=7)
        outs[f"flash_attention_bh {tag}"] = [
            fa.flash_attention_bh(q, k, v, group_size=4)]
        report(args.label, f"flash_attention_bh {tag} Llama-3.2-1B prefill "
               "shape", cs.device_split(
                   lambda: fa.flash_attention_bh(q, k, v, group_size=4), 20),
               cs, flops)
    if args.out:
        torch.save({n: [t.cpu() for t in ts] for n, ts in outs.items()},
                   args.out)
    if args.against:
        saved = torch.load(args.against)
        for n, ts in outs.items():
            got = [t.cpu() for t in ts]
            same = all(torch.equal(a, b) for a, b in zip(got, saved[n]))
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(got, saved[n]))
            print(f"[{args.label}] {n} vs {args.against}: bitwise equal "
                  f"{same}, largest difference {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
