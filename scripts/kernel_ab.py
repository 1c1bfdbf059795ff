"""Time the redesigned kernels of one source tree, on one card, so that
two trees can be compared in one run.

    python3 scripts/kernel_ab.py [--src DIR] [--label NAME]
                                 [--out FILE] [--against FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds that tree's fused-CNN, flash-attention and WKV6 kernels (into the
tree's own ``build/kernels``), and prints the device time per call
(torch.profiler, device events only; ``chip_smoke.device_split``), split
by ``__global__`` function, of

- ``fc_chain_fwd_k`` at the fused round's shape (K=10 users, batch 10) at
  f32 and bf16 and at the eval's (K=1, batch 1000, f32), and the
  single-user ``fc_chain_fwd`` over the same 10 users (one training
  step); the outputs also at an odd cohort (K=3, batch 7) and the eval's
  shape at bf16;
- ``fc_chain_bwd_k`` at the round's shape at f32 and bf16, and the
  single-user ``fc_chain_bwd`` over the same 10 users;
- ``wkv6_bh`` at RWKV6-7B's prefill shape (B=2 x 64 heads, S=2048, D=64;
  r/k/v bf16 and w f32, and all f32);
- ``conv_pool_fwd_k`` per training step (both conv layers of the round's
  cohort, K=10 users, batch 10), the eval's two calls (K=1, batch 1000,
  no residuals) and the single-user ``conv_pool_fwd`` over the same 10
  users, at f32 and bf16;
- ``conv_pool_bwd_k`` per training step (conv2 with dx, conv1 without)
  and the single-user ``conv_pool_bwd`` over the same 10 users, at f32
  and bf16;
- ``flash_attention_bh`` at Llama-3.2-1B's prefill shape (B=2, S=2048, 32
  q / 8 kv heads, causal) at D=32, 64 and 128, bf16 and f32, with its
  TFLOP/s.

The inputs come from fixed seeds.  ``--out`` saves the outputs; with
``--against`` the outputs are compared with a saved file: whether they
are bitwise equal, and the largest difference (every row of the conv
pair, the fc forward and flash attention must be).  To compare two trees on
one card, run them in turns in one command: A, B, B, A.  Needs a CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fc_inputs(cs, k, bs, seed, dt):
    """The fc chain's inputs on the main path: the twins' conv forward of
    a cohort of ``k`` users of batch ``bs`` in dtype ``dt``; and labels."""
    from repro_torch.kernels.fused_cnn import ref
    params, x, y = cs.make_case(k, bs, seed, "cuda")
    params, x = cs._cast(params, dt), x.to(dt)
    a1, _ = ref.conv_pool_fwd_k(x, params["conv1"]["w"], params["conv1"]["b"])
    a2, _ = ref.conv_pool_fwd_k(a1, params["conv2"]["w"],
                                params["conv2"]["b"])
    return a2.reshape(k, bs, -1), params, y


def fc_case(cs, dt):
    """The main path's fc backward inputs: the twins' forward of the
    paper's cohort (K=10, batch 10) in dtype ``dt``."""
    import torch
    from repro_torch.kernels.fused_cnn import ref
    flat, params, y = fc_inputs(cs, 10, 10, 0, dt)
    logits, res = ref.fc_chain_fwd_k(flat, params)
    g = ((torch.softmax(logits.float(), -1)
          - torch.nn.functional.one_hot(y, 10).float()) / 10).to(dt)
    return flat, res, params, g


def user_slices(params, k):
    return [{s: {n: t[i] for n, t in params[s].items()} for s in params}
            for i in range(k)]


def conv_ab(cs, fk, label, dt, tag, outs):
    """The conv pair at the round's shapes: outputs into ``outs``, device
    time per training step (both layers), the eval's two calls and one
    step of 10 single-user calls per layer."""
    import torch
    from repro_torch.kernels.fused_cnn import ref
    params, x, _ = cs.make_case(10, 10, 0, "cuda")
    params, x = cs._cast(params, dt), x.to(dt)
    p1, p2 = params["conv1"], params["conv2"]
    # the twins' forward gives both trees the same backward inputs
    a1, r1 = ref.conv_pool_fwd_k(x, p1["w"], p1["b"])
    a2, r2 = ref.conv_pool_fwd_k(a1, p2["w"], p2["b"])
    g = torch.Generator("cuda").manual_seed(3)
    da2 = (torch.randn(a2.shape, device="cuda", generator=g) * 1e-2).to(dt)
    da1 = (torch.randn(a1.shape, device="cuda", generator=g) * 1e-2).to(dt)
    layers = (("conv1", x, p1, r1, da1, False), ("conv2", a1, p2, r2, da2,
                                                  True))
    for nm, inp, p, _, _, _ in layers:
        a, res = fk.conv_pool_fwd_k(inp, p["w"], p["b"])
        outs[f"conv_pool_fwd_k {tag} {nm} K=10 B=10"] = [a, *res]
    report(label, f"conv_pool_fwd_k {tag} K=10 B=10 (one step, both "
           "layers)", cs.device_split(lambda: [fk.conv_pool_fwd_k(
               inp, p["w"], p["b"]) for _, inp, p, _, _, _ in layers], 50),
           cs)
    p0 = {s: {n: t[:1].contiguous() for n, t in params[s].items()}
          for s in params}
    xe = cs.make_case(1, 1000, 100, "cuda")[1].to(dt)
    ae, _ = ref.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"],
                                False)
    evals = (("conv1", xe, p0["conv1"]), ("conv2", ae, p0["conv2"]))
    for nm, inp, p in evals:
        outs[f"conv_pool_fwd_k {tag} {nm} eval K=1 B=1000"] = [
            fk.conv_pool_fwd_k(inp, p["w"], p["b"], False)[0]]
    report(label, f"conv_pool_fwd_k {tag} eval K=1 B=1000 (both layers)",
           cs.device_split(lambda: [fk.conv_pool_fwd_k(
               inp, p["w"], p["b"], False) for _, inp, p in evals], 20), cs)
    for nm, _, p, res, da, need_dx in layers:
        outs[f"conv_pool_bwd_k {tag} {nm} K=10 B=10"] = [
            t for t in fk.conv_pool_bwd_k(res, p["w"], da, need_dx)
            if t is not None]
    report(label, f"conv_pool_bwd_k {tag} K=10 B=10 (one step: conv2 with "
           "dx, conv1 without)", cs.device_split(lambda: [
               fk.conv_pool_bwd_k(res, p["w"], da, need_dx)
               for _, _, p, res, da, need_dx in layers], 50), cs)
    users = [[(inp[i], p["w"][i], p["b"][i], tuple(r[i] for r in res),
               da[i], need_dx) for _, inp, p, res, da, need_dx in layers]
             for i in range(10)]
    outs[f"conv_pool_fwd {tag} x 10 users"] = [
        t for u in users for xi, wi, bi, _, _, _ in u
        for t in (lambda a, r: (a, *r))(*fk.conv_pool_fwd(xi, wi, bi))]
    outs[f"conv_pool_bwd {tag} x 10 users"] = [
        t for u in users for _, wi, _, ri, dai, ndx in u
        for t in fk.conv_pool_bwd(ri, wi, dai, ndx) if t is not None]
    report(label, f"conv_pool_fwd {tag} x 10 users (one step, both layers)",
           cs.device_split(lambda: [fk.conv_pool_fwd(xi, wi, bi)
                                    for u in users
                                    for xi, wi, bi, _, _, _ in u], 10), cs)
    report(label, f"conv_pool_bwd {tag} x 10 users (one step, both layers)",
           cs.device_split(lambda: [fk.conv_pool_bwd(ri, wi, dai, ndx)
                                    for u in users
                                    for _, wi, _, ri, dai, ndx in u], 10),
           cs)


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
    from repro_torch.kernels.wkv6 import kernel as wk
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build_all(["fused_cnn", "flash_attention", "wkv6"])
    print(f"[{args.label}] {cs.card_line()}; kernels of "
          f"{os.path.dirname(_build.__file__)}; built "
          + ", ".join(f"{n} {s:.1f} s" for n, s in built.items()), flush=True)
    outs = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        conv_ab(cs, fk, args.label, dt, tag, outs)
        # the fc forward: the round's cohort, an odd one and the eval's
        for k, bs, seed in ((10, 10, 0), (3, 7, 1), (1, 1000, 2)):
            flat, params, _ = fc_inputs(cs, k, bs, seed, dt)
            logits, (h1, h2) = fk.fc_chain_fwd_k(flat, params)
            outs[f"fc_chain_fwd_k {tag} K={k} B={bs}"] = [logits, h1, h2]
            if k == 10 or (k == 1 and tag == "f32"):
                report(args.label, f"fc_chain_fwd_k {tag} K={k} B={bs}",
                       cs.device_split(
                           lambda: fk.fc_chain_fwd_k(flat, params), 50), cs)
        flat, res, params, g = fc_case(cs, dt)
        users = user_slices(params, 10)
        outs[f"fc_chain_fwd {tag} x 10 users"] = []
        for i, p in enumerate(users):
            logits, (h1, h2) = fk.fc_chain_fwd(flat[i], p)
            outs[f"fc_chain_fwd {tag} x 10 users"] += [logits, h1, h2]

        def single_fwd():
            for i, p in enumerate(users):
                fk.fc_chain_fwd(flat[i], p)
        report(args.label, f"fc_chain_fwd {tag} x 10 users (one step)",
               cs.device_split(single_fwd, 10), cs)

        grads, dflat = fk.fc_chain_bwd_k(flat, res, params, g)
        outs[f"fc_chain_bwd_k {tag}"] = [dflat] + [
            grads[n][leaf] for n in ("fc1", "fc2", "fc3")
            for leaf in ("w", "b")]
        report(args.label, f"fc_chain_bwd_k {tag} K=10 B=10",
               cs.device_split(lambda: fk.fc_chain_bwd_k(flat, res, params,
                                                          g), 50), cs)

        def single_bwd():
            for i, p in enumerate(users):
                fk.fc_chain_bwd(flat[i], tuple(r[i] for r in res), p, g[i])
        report(args.label, f"fc_chain_bwd {tag} x 10 users (one step)",
               cs.device_split(single_bwd, 10), cs)
    for d in (32, 64, 128):
        flops = 4.0 * d * (2048 * 2049 // 2) * 2 * 32  # causal q.k and p.v
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q, k, v = cs.flash_inputs(2, 32, 8, 2048, 2048, d, dt, seed=7)
            outs[f"flash_attention_bh {tag} D={d}"] = [
                fa.flash_attention_bh(q, k, v, group_size=4)]
            report(args.label, f"flash_attention_bh {tag} D={d} "
                   "Llama-3.2-1B prefill shape", cs.device_split(
                       lambda: fa.flash_attention_bh(q, k, v, group_size=4),
                       20), cs, flops)
    # 5 ops a state element and step (FMA = 2) and 5 a column, as
    # chip_smoke.time_zoo_kernels counts them
    wflops = 5.0 * 64 * 65 * 2048 * 128
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        r, k, v, w, u = cs.wkv_inputs(128, 2048, 64, dt, seed=8)
        outs[f"wkv6_bh {tag}"] = list(wk.wkv6_bh(r, k, v, w, u))
        report(args.label, f"wkv6_bh {tag} RWKV6-7B prefill shape",
               cs.device_split(lambda: wk.wkv6_bh(r, k, v, w, u), 20), cs,
               wflops)
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
