"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. card: name and power limit from nvidia-smi, torch and CUDA versions.
   TF32 is switched off for matmuls and cuDNN, so every f32 product on the
   card (kernels and plain twins alike) runs in full f32;
2. build: the fused-CNN kernels from the sources in this checkout (nvcc,
   sm_90a);
3. kernels vs their plain PyTorch twins on the card, at the main path's
   shapes (K=10 users, batch 10, both conv layers), an odd cohort (K=3,
   B=7), the eval shape (K=1, B=1000) and an all-ones pool-tie cohort;
   each kernel's device time per training step (both conv layers' calls
   for the conv kernels; torch.profiler) is printed beside its twin's and
   its bound, and beside the wall time of back-to-back calls (CUDA events),
   which the host's launch rate sets;
4. the main path: ``HSFLSimulation`` at the paper's configuration on the
   card, 5 rounds of opt (b=2) and 2 rounds of every other registered
   scheme; the kernels' launch counts must equal what those rounds need;
5. card vs CPU: 2 rounds of opt from the same seed and params on both;
   counts must be identical and params and accuracy close;
6. the card's line, the kernels' JSON line, and the result line.

It imports nothing of JAX.  Without a CUDA card it exits 2 and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the phases take their device from here, so that they can be rehearsed on
# the CPU (where every wrapper runs its twin) before a run on the card
DEVICE = "cuda"

# f32 tolerances (relative to the largest magnitude of the reference):
# outputs and grads of a kernel vs its twin on the same inputs differ only
# by summation order (FMA vs separate rounding, block partial sums), a few
# ulps of the largest term; 1e-5 leaves two orders of margin.  The conv
# forward sums in the twin's order, so its masks must agree exactly.
KERNEL_RTOL = 1e-5
# card vs CPU after 2 rounds x 24 SGD steps: per-step differences of
# ~1e-7 accumulate through the updates, far below 1e-4
PARAM_ATOL = 1e-4

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12         # H100 SXM f32, outside the tensor cores

# where each TPU kernel lives in the JAX package (pallas_call lines)
REPLACES = {
    "conv_pool_fwd_k": "src/repro/kernels/fused_cnn/kernel.py:291",
    "conv_pool_bwd_k": "src/repro/kernels/fused_cnn/kernel.py:357",
    "fc_chain_fwd_k": "src/repro/kernels/fused_cnn/kernel.py:398",
    "fc_chain_bwd_k": "src/repro/kernels/fused_cnn/kernel.py:441",
}
SOURCE = "src/repro_torch/kernels/fused_cnn/csrc/fused_cnn.cu"
# __global__ launches per wrapper call
LAUNCHES_PER_CALL = {"conv_pool_fwd_k": 1, "conv_pool_bwd_k": 2,
                     "fc_chain_fwd_k": 1, "fc_chain_bwd_k": 2}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls,
    timed with CUDA events after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(prof) -> float:
    """Summed device time (us) of a profile's kernels and copies; the
    profiler's own buffer bookkeeping is left out."""
    total = 0.0
    for ev in prof.key_averages():
        if ev.key.startswith("Activity Buffer"):
            continue
        total += float(getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0.0)))
    return total


def device_ms(fn, iters: int) -> float:
    """Mean device time (ms) per call of ``fn``: the summed durations of
    the kernels it launches, from torch.profiler, over ``iters`` calls
    after a warm-up call.  Host-side launch gaps are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = _device_us(prof)
    if not us > 0:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / iters


def bound_ms(nbytes: float, flops: float):
    """The least time for the work: bytes over HBM rate vs f32 operations
    over the f32 peak, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def numel(*ts) -> int:
    return sum(int(t.numel()) for t in ts if t is not None)


def rel_err(got, want) -> tuple:
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    return err, err / scale


# ---------------------------------------------------------------------------
# phase 3: each kernel against its twin
# ---------------------------------------------------------------------------

def make_case(k: int, bs: int, seed: int, device, ones: bool = False):
    """Stacked params and images for a cohort: digits images (constant
    backgrounds give pool ties) or all-ones images (every window tied)."""
    import torch
    from repro_torch.data.synthetic import make_digits
    from repro_torch.models.cnn import init_cnn
    from repro_torch.utils.tree import tree_map
    per_user = [init_cnn(seed + i, "cpu") for i in range(k)]
    params = tree_map(lambda *ls: torch.stack(ls).to(device), *per_user)
    if ones:
        x = torch.ones((k, bs, 28, 28, 1))
        y = torch.tensor(np.tile([1, 7], (k, (bs + 1) // 2))[:, :bs])
    else:
        ds = make_digits(k * bs, seed=seed)
        x = torch.from_numpy(ds.x).reshape(k, bs, 28, 28, 1)
        y = torch.from_numpy(ds.y.astype(np.int64)).reshape(k, bs)
    return params, x.to(device), y.to(device)


class Check:
    """Compares kernel outputs with their twin's and keeps each kernel's
    largest absolute error."""

    def __init__(self):
        self.err = {n: 0.0 for n in REPLACES}

    def close(self, name: str, what: str, got, want, exact: bool = False):
        err, rel = rel_err(got, want)
        self.err[name] = max(self.err[name], err)
        ok = err == 0.0 if exact else rel <= KERNEL_RTOL
        print(f"  {name:16s} {what:28s} max_abs_err={err:.3e} "
              f"rel={rel:.3e} {'exact' if exact else f'tol {KERNEL_RTOL}'}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain twin (abs {err}, rel {rel})")


def check_case(chk: Check, label: str, k: int, bs: int, seed: int,
               ones: bool = False):
    """Every kernel vs its twin on one cohort, all on the card: the twin's
    forward feeds both sides of every later check, so each comparison sees
    identical inputs."""
    import torch
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x, y = make_case(k, bs, seed, DEVICE, ones)
    print(f" case {label}: K={k} B={bs}")
    p1, p2 = params["conv1"], params["conv2"]

    a1k, r1k = knl.conv_pool_fwd_k(x, p1["w"], p1["b"])
    a1, r1 = ref.conv_pool_fwd_k(x, p1["w"], p1["b"])
    chk.close("conv_pool_fwd_k", "conv1 a", a1k, a1, exact=True)
    for nm, gk, gp in zip(("pat", "eq", "relu_m"), r1k, r1):
        chk.close("conv_pool_fwd_k", f"conv1 {nm}", gk, gp, exact=True)
    a2k, r2k = knl.conv_pool_fwd_k(a1, p2["w"], p2["b"])
    a2, r2 = ref.conv_pool_fwd_k(a1, p2["w"], p2["b"])
    chk.close("conv_pool_fwd_k", "conv2 a", a2k, a2, exact=True)
    for nm, gk, gp in zip(("pat", "eq", "relu_m"), r2k, r2):
        chk.close("conv_pool_fwd_k", f"conv2 {nm}", gk, gp, exact=True)

    flat = a2.reshape(k, bs, -1)
    logits_k, (h1k, h2k) = knl.fc_chain_fwd_k(flat, params)
    logits, (h1, h2) = ref.fc_chain_fwd_k(flat, params)
    chk.close("fc_chain_fwd_k", "logits", logits_k, logits)
    chk.close("fc_chain_fwd_k", "h1", h1k, h1)
    chk.close("fc_chain_fwd_k", "h2", h2k, h2)

    onehot = torch.nn.functional.one_hot(y, 10).float()
    g = (torch.softmax(logits, -1) - onehot) / bs
    gk, dflat_k = knl.fc_chain_bwd_k(flat, (h1, h2), params, g)
    gp, dflat = ref.fc_chain_bwd_k(flat, (h1, h2), params, g)
    for layer in ("fc1", "fc2", "fc3"):
        for leaf in ("w", "b"):
            chk.close("fc_chain_bwd_k", f"d{layer}.{leaf}", gk[layer][leaf],
                      gp[layer][leaf])
    chk.close("fc_chain_bwd_k", "dflat", dflat_k, dflat)

    da2 = dflat.reshape(a2.shape)
    for nm, res, w, da, need_dx in (("conv2", r2, p2["w"], da2, True),
                                    ("conv1", r1, p1["w"], None, False),
                                    ("conv1+dx", r1, p1["w"], None, True)):
        if da is None:
            da = torch.randn(a1.shape, generator=torch.Generator(
                DEVICE).manual_seed(seed), device=DEVICE) * 1e-2
        outk = knl.conv_pool_bwd_k(res, w, da, need_dx)
        outp = ref.conv_pool_bwd_k(res, w, da, need_dx)
        for part, gk_, gp_ in zip(("dw", "db", "dx"), outk, outp):
            if gp_ is not None:
                chk.close("conv_pool_bwd_k", f"{nm} {part}", gk_, gp_)

    if ones:
        return
    # eval shape: K=1, B=1000, forward only, no residuals
    p0 = {s: {n: t[:1].contiguous() for n, t in params[s].items()}
          for s in params}
    xe = make_case(1, 1000, seed + 100, DEVICE)[1]
    ek, _ = knl.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"],
                                residuals=False)
    ep, _ = ref.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"],
                                residuals=False)
    chk.close("conv_pool_fwd_k", "eval conv1 a (K=1,B=1000)", ek, ep,
              exact=True)
    e2k, _ = knl.conv_pool_fwd_k(ep, p0["conv2"]["w"], p0["conv2"]["b"],
                                 residuals=False)
    e2p, _ = ref.conv_pool_fwd_k(ep, p0["conv2"]["w"], p0["conv2"]["b"],
                                 residuals=False)
    chk.close("conv_pool_fwd_k", "eval conv2 a (K=1,B=1000)", e2k, e2p,
              exact=True)
    lk, _ = knl.fc_chain_fwd_k(e2p.reshape(1, 1000, -1), p0)
    lp, _ = ref.fc_chain_fwd_k(e2p.reshape(1, 1000, -1), p0)
    chk.close("fc_chain_fwd_k", "eval logits (K=1,B=1000)", lk, lp)


def time_kernels(k: int = 10, bs: int = 10, seed: int = 0) -> dict:
    """Kernel vs twin time per training step at the main path's shapes
    (both conv layers for the conv kernels), with bytes/operations bounds."""
    import torch
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x, y = make_case(k, bs, seed, DEVICE)
    p1, p2 = params["conv1"], params["conv2"]
    a1, r1 = ref.conv_pool_fwd_k(x, p1["w"], p1["b"])
    a2, r2 = ref.conv_pool_fwd_k(a1, p2["w"], p2["b"])
    flat = a2.reshape(k, bs, -1)
    logits, rfc = ref.fc_chain_fwd_k(flat, params)
    g = (torch.softmax(logits, -1)
         - torch.nn.functional.one_hot(y, 10).float()) / bs
    _, dflat = ref.fc_chain_bwd_k(flat, rfc, params, g)
    da2 = dflat.reshape(a2.shape)
    _, _, da1 = ref.conv_pool_bwd_k(r2, p2["w"], da2, True)
    fcw = [params[n][t] for n in ("fc1", "fc2", "fc3") for t in ("w", "b")]

    def conv_fwd(mod):
        mod.conv_pool_fwd_k(x, p1["w"], p1["b"])
        mod.conv_pool_fwd_k(a1, p2["w"], p2["b"])

    def conv_bwd(mod):
        mod.conv_pool_bwd_k(r2, p2["w"], da2, True)
        mod.conv_pool_bwd_k(r1, p1["w"], da1, False)

    def fc_fwd(mod):
        mod.fc_chain_fwd_k(flat, params)

    def fc_bwd(mod):
        mod.fc_chain_bwd_k(flat, rfc, params, g)

    def conv_flops(xin, w):
        kk, b_, h, wd, c = xin.shape
        return 2.0 * kk * b_ * h * wd * 9 * c * w.shape[-1]

    d1, d2, d3 = 128, 64, 10
    f = flat.shape[-1]
    fc_flops = 2.0 * k * bs * (f * d1 + d1 * d2 + d2 * d3)
    work = {   # (bytes moved once, operations) per training step
        "conv_pool_fwd_k": (
            4 * numel(x, p1["w"], p1["b"], a1, *r1, a1, p2["w"], p2["b"],
                      a2, *r2),
            conv_flops(x, p1["w"]) + conv_flops(a1, p2["w"])),
        "conv_pool_bwd_k": (
            4 * numel(*r2, p2["w"], da2, p2["w"], p2["b"], a1,
                      *r1, p1["w"], da1, p1["w"], p1["b"]),
            2 * conv_flops(a1, p2["w"]) + conv_flops(x, p1["w"])),
        "fc_chain_fwd_k": (4 * numel(flat, *fcw, logits, *rfc), fc_flops),
        "fc_chain_bwd_k": (4 * numel(flat, *rfc, *fcw[::2], g, *fcw, flat),
                           2 * fc_flops),
    }
    fns = {"conv_pool_fwd_k": conv_fwd, "conv_pool_bwd_k": conv_bwd,
           "fc_chain_fwd_k": fc_fwd, "fc_chain_bwd_k": fc_bwd}
    out = {}
    for name, fn in fns.items():
        ms = device_ms(lambda: fn(knl), iters=50)
        plain = device_ms(lambda: fn(ref), iters=10)
        wall = cuda_ms(lambda: fn(knl), iters=200)
        b_ms, by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": by, "wall_ms": wall}
        print(f"  {name:16s} per step: kernel {ms * 1e3:9.2f} us  twin "
              f"{plain * 1e3:9.2f} us  bound {b_ms * 1e3:6.2f} us ({by}, "
              f"{work[name][0] / 1e6:.2f} MB, {work[name][1] / 1e6:.1f} "
              f"MFLOP)  back-to-back wall {wall * 1e3:9.2f} us")

    # eval shape (K=1, B=1000): forward kernels without residuals
    p0 = {s: {n: t[:1].contiguous() for n, t in params[s].items()}
          for s in params}
    xe = make_case(1, 1000, seed + 100, DEVICE)[1]
    ae, _ = ref.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"], False)

    def eval_conv(mod):
        mod.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"], False)
        mod.conv_pool_fwd_k(ae, p0["conv2"]["w"], p0["conv2"]["b"], False)

    def eval_fc(mod):
        mod.fc_chain_fwd_k(ae2.reshape(1, 1000, -1), p0)

    ae2, _ = ref.conv_pool_fwd_k(ae, p0["conv2"]["w"], p0["conv2"]["b"],
                                 False)
    for label, fn in (("conv_pool_fwd_k", eval_conv),
                      ("fc_chain_fwd_k", eval_fc)):
        ms = device_ms(lambda: fn(knl), iters=20)
        plain = device_ms(lambda: fn(ref), iters=3)
        print(f"  {label:16s} eval (K=1,B=1000): kernel {ms * 1e3:9.2f} us  "
              f"twin {plain * 1e3:9.2f} us")
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def run_rounds(cfg, device, params=None):
    """Run ``cfg.rounds`` rounds; returns (sim, per-round rows, ms/round)."""
    import torch
    from repro_torch.core.hsfl import HSFLSimulation
    from repro_torch.utils.tree import tree_map
    sim = HSFLSimulation(cfg, device=device)
    if params is not None:
        sim.params = tree_map(lambda t: t.to(sim.device).clone(), params)
    rows, times, delayed = [], [], []
    for t in range(1, cfg.rounds + 1):
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        log, delayed = sim.run_round(t, delayed)
        log.test_loss, log.test_acc = sim.evaluate()   # reads back: syncs
        times.append((time.perf_counter() - t0) * 1e3)
        rows.append((log.selected, log.arrived_final, log.used_snapshot,
                     log.delayed, log.dropped, log.bytes_sent,
                     log.test_loss, log.test_acc))
    return sim, rows, times


def expected_launches(cfg, rows) -> dict:
    """__global__ launches the rounds need: every trained round runs
    e·S steps (2 conv fwd, 2 conv bwd, 1 fc fwd, 1 fc bwd calls each), and
    every eval 2 conv fwd + 1 fc fwd calls."""
    steps = sum(cfg.local_epochs * cfg.steps_per_epoch
                for r in rows if r[0] > 0)
    evals = len(rows)
    calls = {"conv_pool_fwd_k": 2 * steps + 2 * evals,
             "conv_pool_bwd_k": 2 * steps,
             "fc_chain_fwd_k": steps + evals,
             "fc_chain_bwd_k": steps}
    return {n: c * LAUNCHES_PER_CALL[n] for n, c in calls.items()}


def params_finite(params) -> bool:
    import torch
    from repro_torch.utils.tree import tree_leaves
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))


def print_rounds(label: str, rows, times):
    for i, (r, ms) in enumerate(zip(rows, times), 1):
        print(f"  {label} round {i}: selected={r[0]} arrived={r[1]} "
              f"rescued={r[2]} delayed={r[3]} dropped={r[4]} "
              f"bytes={r[5]:.0f} test_loss={r[6]:.4f} test_acc={r[7]:.4f} "
              f"ms={ms:.1f}")


def main_path():
    """Paper-config rounds on the card for every registered scheme; returns
    the launch counts of this run."""
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.core.schemes import registered_schemes
    from repro_torch.kernels.fused_cnn import kernel as knl
    runs = [("opt", 5)] + [(s, 2) for s in registered_schemes() if s != "opt"]
    want = {n: 0 for n in knl.LAUNCHES}
    knl.reset_launches()
    for scheme, rounds in runs:
        b = 2 if scheme in ("opt", "deadline") or scheme.startswith("opt_") \
            else 1
        cfg = HSFLConfig(rounds=rounds, scheme=scheme, b=b)
        sim, rows, times = run_rounds(cfg, DEVICE)
        print_rounds(f"{scheme}(b={b})", rows, times)
        if not params_finite(sim.params):
            raise AssertionError(f"{scheme}: non-finite params")
        for n, c in expected_launches(cfg, rows).items():
            want[n] += c
        if scheme == "opt" and not rows[-1][7] > 0.1:
            raise AssertionError(f"opt accuracy {rows[-1][7]} is not above "
                                 "chance (0.1) after 5 rounds")
        if scheme == "opt":
            steady = times[1:]
            print(f"  opt ms/round (rounds 2-5): median "
                  f"{float(np.median(steady)):.1f}, min {min(steady):.1f}")
    got = dict(knl.LAUNCHES)
    print(f"  launches: {got}")
    if got != want:
        raise AssertionError(f"launch counts {got} != expected {want}")
    if min(got.values()) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    return got


def device_busy_share():
    """Share of one steady opt round's wall time the card spends in
    kernels, from torch.profiler; None when the profiler sees no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    sim = HSFLSimulation(HSFLConfig(rounds=2, scheme="opt", b=2), DEVICE)
    sim.run_round(1, [])
    sim.evaluate()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(2, [])
        sim.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = _device_us(prof)
    if dev_us <= 0:
        print("  profiler: no device time recorded (busy share not measured)")
        return None
    share = dev_us / 1e6 / wall
    print(f"  profiler: one opt round + eval: wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_us / 1e3:.2f} ms -> busy share {share:.3f}, "
          f"idle share {1 - share:.3f}")
    dev = lambda e: float(getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)))
    for ev in sorted(prof.key_averages(), key=dev, reverse=True)[:12]:
        print(f"    {dev(ev) / 1e3:8.3f} ms  x{ev.count:5d}  {ev.key[:70]}")
    return share


def card_vs_cpu():
    """2 opt rounds from one seed and one set of params on the card and on
    the CPU: identical counts, params within PARAM_ATOL, accuracy within
    one test image."""
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.models.cnn import init_cnn
    cfg = HSFLConfig(rounds=2, scheme="opt", b=2)
    p0 = init_cnn(cfg.seed, "cpu")
    sim_g, rows_g, _ = run_rounds(cfg, DEVICE, p0)
    sim_c, rows_c, _ = run_rounds(cfg, "cpu", p0)
    print_rounds("card", rows_g, [0.0] * len(rows_g))
    print_rounds("cpu ", rows_c, [0.0] * len(rows_c))
    if [r[:6] for r in rows_g] != [r[:6] for r in rows_c]:
        raise AssertionError("card and CPU counts differ")
    from repro_torch.utils.tree import tree_leaves
    diff = max(float((g.cpu() - c).abs().max()) for g, c in zip(
        tree_leaves(sim_g.params), tree_leaves(sim_c.params)))
    dacc = max(abs(g[7] - c[7]) for g, c in zip(rows_g, rows_c))
    print(f"  max |param card - param cpu| = {diff:.3e} (tol {PARAM_ATOL}); "
          f"max |acc diff| = {dacc:.4f} (tol {1 / cfg.n_test})")
    if not diff <= PARAM_ATOL:
        raise AssertionError(f"card vs CPU params differ by {diff}")
    if not dacc <= 1.0 / cfg.n_test + 1e-9:
        raise AssertionError(f"card vs CPU accuracy differs by {dacc}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    print("== phase 1: card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    print("== phase 2: build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.find_nvcc()})")
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    print(f"  ptxas {line.strip()}")

    print("== phase 3: kernels vs plain twins on the card")
    chk = Check()
    check_case(chk, "main path", 10, 10, seed=0)
    check_case(chk, "odd cohort", 3, 7, seed=1)
    check_case(chk, "all-ones ties", 3, 2, seed=2, ones=True)
    torch.cuda.synchronize()
    timing = time_kernels()

    print("== phase 4: main path (paper config, every scheme)")
    launches = main_path()
    share = device_busy_share()

    print("== phase 5: card vs CPU")
    card_vs_cpu()

    rows = [{"name": n, "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[n], "launches": launches[n],
             "max_abs_err": chk.err[n], "ms": timing[n]["ms"],
             "plain_ms": timing[n]["plain_ms"],
             "bound_ms": timing[n]["bound_ms"],
             "bound_by": timing[n]["bound_by"], "library_ms": None}
            for n in REPLACES]
    for r in rows:
        if not all(isinstance(r[key], (int, float)) and math.isfinite(r[key])
                   for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            raise AssertionError(f"non-finite number in {r}")
    print(f"device busy share (one opt round + eval): "
          f"{'not measured' if share is None else f'{share:.4f}'}")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
