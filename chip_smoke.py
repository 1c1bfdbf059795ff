"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. card: name and power limit from nvidia-smi, torch and CUDA versions.
   TF32 is switched off for matmuls and cuDNN, so every f32 product on the
   card (kernels and plain twins alike) runs in full f32;
2. build: the fused-CNN, delta-codec, flash-attention and WKV6 kernels
   from the sources in this checkout, one nvcc each, in parallel (sm_90a);
   the seconds it took, and each kernel's registers and spills;
3. kernels vs their plain PyTorch twins on the card.  Blocked fused CNN:
   the main path's shapes (K=10 users, batch 10, both conv layers) at f32
   and bf16, an odd cohort (K=3, B=7), the eval shape (K=1, B=1000) and an
   all-ones pool-tie cohort.  Single-user fused CNN: one user of batch 10
   and the all-ones tie case, at f32 and bf16, also held bit for bit to
   the blocked kernels at K=1.  Delta codec, bitwise: M = 2560 (the fused
   round's 256·10 rows) and 217 (one tree), blocks 512 and 128, int8 and
   int4, with all-zero rows and lanes on exact .5 quanta.  At bf16 the
   share of bitwise-equal elements and the count of pool windows whose tie
   masks differ are printed.  Each kernel's device time (torch.profiler)
   is printed beside its twin's, its bound, the one PyTorch call that
   computes the same function where there is one, and the wall time of
   back-to-back calls (CUDA events); the fc forward's and backward's
   times are also split by ``__global__`` function;
4. the fused path: ``HSFLSimulation`` at the paper's configuration, 5
   rounds of opt (b=2) with and without the delta codec and 2 rounds of
   every other registered scheme; every kernel's launch count must equal
   what those rounds need (the codec: one quantize per probe epoch, one
   dequantize per round);
5. the policy path: the same opt rounds under ``precision="bf16"``,
   ``batch_users=False`` at f32 and bf16 (the single-user kernels, once
   per user slot) and ``kernel="im2col"`` at f32 and bf16 (autograd); the
   launch counts must equal what the rounds' slots need, and one bf16
   round runs under the profiler;
6. the serving path at the paper's configuration with the codec, through
   ``repro_torch.launch.serve_fl.main``: (a) 4 rounds under the restart
   supervisor with duplicated and corrupted uploads and a crash while
   checkpointing round 3, (b) the same 4 rounds with no faults, (c) the
   host engine alone.  The final params of (a), (b) and (c) must be
   equal bit for bit, and the codec kernels must have launched;
7. card vs CPU: 2 rounds of the fused opt round, of the fused codec round
   and of the codec server, and one round under bf16 and one under
   ``batch_users=False``, from the same seed and params on both; counts
   must be identical and params and accuracy close;
8. the zoo path.  (a) flash attention and WKV6 against their twins at
   Llama-3.2-1B's and RWKV6-7B's prefill shapes (B=2, S=2048; masks,
   ragged S, Sq < Sk; WKV6 also at D=32 and 128; bf16 and f32), and flash
   attention at hubert-xlarge's (B=2, 16 q and 16 kv heads, D=80, S=1500
   frames, non-causal), each timed beside its twin, its bound and, for
   attention, ``scaled_dot_product_attention`` (a yardstick only), with
   both attentions' TFLOP/s; (b) ``make_prefill_step`` on Llama-3.2-1B as
   configured and on RWKV6-7B at full width with 4 of its 32 layers, B=2
   x 2048-token prompts, counts reset just before: one kernel launch per
   layer; (c) the kernel path against the cache path (the token loop of
   ``serving.decode.prefill``) over a 256-token prompt at bf16 and f32;
   (d) ``launch/serve.py`` on Llama-3.2-1B and ``generate`` on the 4-layer
   RWKV6-7B, tokens per second; (e) card vs CPU at the reduced size:
   logits, and greedy tokens equal at f32.  The phase prints its wall
   time;
9. the card's line, the kernels' JSON line, and the result line.

It imports nothing of JAX.  Without a CUDA card it exits 2 and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import shutil
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
# bf16 outputs of a kernel vs its twin: both accumulate in f32, but where
# their sums run in another order a value may round to the neighbouring
# bf16; two bf16 ulps of the largest magnitude (2**-6) bound it.  The conv
# forward sums in the twin's order and must agree exactly at bf16 too
BF16_RTOL = 2 ** -6
# card vs CPU after one bf16 round (24 SGD steps of 10 users): relative
# Frobenius error per leaf.  Kernel and twin sum some f32 products in
# another order, so a rare value rounds to the neighbouring bf16, and a
# one-ulp difference in a bf16 weight moves every later rounding: bf16
# trajectories drift apart where f32 ones stay within 1e-7.  The drift is
# largest on the biases, which start at zero (on the CPU two bf16 runs
# that differ only in summation order are 2.3% apart on conv1.b after ten
# epochs, tests/test_torch_policy.py); 5% bounds it
BF16_FROB = 0.05
# card vs CPU after 2 rounds x 24 SGD steps: per-step differences of
# ~1e-7 accumulate through the updates, far below 1e-4.  With the codec a
# 1e-7 difference may move one lane of a rescued snapshot across a .5
# boundary, so codec runs add one quantization step: the largest scale
# either side's codec produced
PARAM_ATOL = 1e-4

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12         # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16, tensor cores, dense

# where each TPU kernel lives in the JAX package (pallas_call lines)
REPLACES = {
    "conv_pool_fwd": "src/repro/kernels/fused_cnn/kernel.py:117",
    "conv_pool_bwd": "src/repro/kernels/fused_cnn/kernel.py:159",
    "fc_chain_fwd": "src/repro/kernels/fused_cnn/kernel.py:188",
    "fc_chain_bwd": "src/repro/kernels/fused_cnn/kernel.py:224",
    "conv_pool_fwd_k": "src/repro/kernels/fused_cnn/kernel.py:291",
    "conv_pool_bwd_k": "src/repro/kernels/fused_cnn/kernel.py:357",
    "fc_chain_fwd_k": "src/repro/kernels/fused_cnn/kernel.py:398",
    "fc_chain_bwd_k": "src/repro/kernels/fused_cnn/kernel.py:441",
    "quantize_blocks": "src/repro/kernels/delta_codec/kernel.py:75",
    "dequantize_blocks": "src/repro/kernels/delta_codec/kernel.py:92",
    "flash_attention_bh": "src/repro/kernels/flash_attention/kernel.py:99",
    "wkv6_bh": "src/repro/kernels/wkv6/kernel.py:61",
}
FUSED_CNN = ("conv_pool_fwd_k", "conv_pool_bwd_k", "fc_chain_fwd_k",
             "fc_chain_bwd_k")
USER_CNN = ("conv_pool_fwd", "conv_pool_bwd", "fc_chain_fwd", "fc_chain_bwd")
CODEC = ("quantize_blocks", "dequantize_blocks")
ZOO = ("flash_attention_bh", "wkv6_bh")
SOURCES = {**{n: "src/repro_torch/kernels/fused_cnn/csrc/fused_cnn.cu"
              for n in FUSED_CNN + USER_CNN},
           **{n: "src/repro_torch/kernels/delta_codec/csrc/delta_codec.cu"
              for n in CODEC},
           "flash_attention_bh":
               "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
           "wkv6_bh": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"}
# scratch for the serving phase's checkpoints (git-ignored)
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
# __global__ launches per wrapper call
LAUNCHES_PER_CALL = {"conv_pool_fwd_k": 1, "conv_pool_bwd_k": 1,
                     "fc_chain_fwd_k": 1, "fc_chain_bwd_k": 1,
                     "conv_pool_fwd": 1, "conv_pool_bwd": 1,
                     "fc_chain_fwd": 1, "fc_chain_bwd": 1}


def sync() -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``ns::name<args>`` of a mangled ``_ZN...`` entry, as
    ``name<args>`` with the template argument codes spelled out (``f``
    float, ``13__nv_bfloat16`` bf16, ``Li64E`` 64)."""
    import re
    if not mangled.startswith("_ZN"):
        return mangled
    i, parts = 3, []
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group(0)
        i += len(n)
        parts.append(mangled[i:i + int(n)])
        i += int(n)
    args = ""
    if mangled[i:i + 1] == "I":
        codes = re.match(r"((?:Li\d+E|13__nv_bfloat16|f)+)E", mangled[i + 1:])
        if codes:
            names = [n or {"f": "float"}.get(c, "bf16") for n, c in
                     re.findall(r"Li(\d+)E|(13__nv_bfloat16|f)",
                                codes.group(1))]
            args = f"<{', '.join(names)}>"
    return (parts[-1] if parts else mangled) + args


def ptxas_summary(log: str) -> list:
    """(kernel, registers, spill line) for each entry function that
    ``nvcc -Xptxas -v`` reports in a build log."""
    import re
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            out.append((entry, int(re.search(r"Used (\d+) registers",
                                             line).group(1)), spill))
            entry = None
    return out


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


def _self_device_us(ev) -> float:
    return float(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)))


def _device_events(prof) -> list:
    """A profile's events on the device (kernels, copies), by name.  A host
    op (``aten::mm``) carries the device time of the kernels it launched
    as its own, so counting host events too would count those kernels
    twice.  The profiler's own buffer bookkeeping is left out."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not ev.key.startswith("Activity Buffer")]


def _device_us(prof) -> float:
    """Summed device time (us) of a profile's kernels and copies."""
    return sum(_self_device_us(ev) for ev in _device_events(prof))


def print_top_kernels(prof, top: int) -> None:
    for ev in sorted(_device_events(prof), key=_self_device_us,
                     reverse=True)[:top]:
        print(f"    {_self_device_us(ev) / 1e3:8.3f} ms  x{ev.count:5d}  "
              f"{ev.key[:70]}")


def short_name(kernel: str) -> str:
    """A profiler's kernel name without its return type, namespace and
    parameter list."""
    return kernel.replace("(anonymous namespace)::", "").removeprefix(
        "void ").split("(")[0]


def device_split(fn, iters: int) -> dict:
    """Mean device time (ms) per call of ``fn`` for each kernel it
    launches, by name, from torch.profiler, over ``iters`` calls after a
    warm-up call.  Host-side launch gaps are not counted.

    Late in a long process the profiler loses a few kernel records of a
    session (2 or 3 of 10 to 20 launches of one kernel in the zoo phase,
    on the H100), so the summed time over ``iters`` reads low.  Each kernel is therefore timed
    as its mean over the records there are, times its launches per call:
    the record count over ``iters``, rounded (exact while fewer than
    ``iters / 2`` records of it are lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split, lost = {}, 0
    for ev in _device_events(prof):
        if ev.count:
            per_call = max(1, round(ev.count / iters))
            lost += per_call * iters - ev.count
            split[ev.key] = _self_device_us(ev) / ev.count * per_call / 1e3
    if lost > 0:
        print(f"    (the profiler lost {lost} kernel records of {iters} "
              f"calls; timed from the records it kept)")
    if not sum(split.values()) > 0:
        raise AssertionError("the profiler recorded no device time")
    return split


def device_ms(fn, iters: int) -> float:
    """Mean device time (ms) per call of ``fn``: the summed durations of
    the kernels it launches (``device_split``)."""
    return sum(device_split(fn, iters).values())


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS_PER_S):
    """The least time for the work: bytes over HBM rate vs operations over
    the peak ``rate`` for their type (f32 by default), whichever is
    larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def numel(*ts) -> int:
    return sum(int(t.numel()) for t in ts if t is not None)


def rel_err(got, want) -> tuple:
    """(max abs error, max abs error / max |want|), in f64 (int8 q too)."""
    got, want = got.double(), want.double()
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
    largest absolute error; at bf16 also the smallest share of bitwise-equal
    elements and the pool windows whose tie masks differ."""

    def __init__(self):
        self.err = {n: 0.0 for n in REPLACES}
        self.bf16_equal = {}
        self.tie_windows = {}

    def close(self, name: str, what: str, got, want, exact: bool = False,
              rtol: float = KERNEL_RTOL):
        import torch
        err, rel = rel_err(got, want)
        self.err[name] = max(self.err[name], err)
        ok = err == 0.0 if exact else rel <= rtol
        extra = ""
        if want.dtype == torch.bfloat16:
            share = float((got == want).double().mean())
            self.bf16_equal[name] = min(self.bf16_equal.get(name, 1.0), share)
            extra = f" bitwise {share:.4f}"
        print(f"  {name:16s} {what:30s} max_abs_err={err:.3e} "
              f"rel={rel:.3e} {'exact' if exact else f'tol {rtol:.2e}'}"
              f"{extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain twin (abs {err}, rel {rel})")

    def windows(self, name: str, eq_k, eq_p) -> None:
        """Count the 2x2 pool windows whose tie masks differ."""
        d = eq_k != eq_p
        *lead, h, w, o = d.shape
        n = int(d.reshape(*lead, h // 2, 2, w // 2, 2, o).any(dim=-2)
                .any(dim=-3).sum())
        self.tie_windows[name] = self.tie_windows.get(name, 0) + n


def _cast(tree, dtype):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(dtype), tree)


def check_case(chk: Check, label: str, k: int, bs: int, seed: int,
               ones: bool = False, bf16: bool = False):
    """Every blocked kernel vs its twin on one cohort, all on the card: the
    twin's forward feeds both sides of every later check, so each
    comparison sees identical inputs.  ``bf16`` runs the bf16
    instantiations on the same cohort rounded to bf16."""
    import torch
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x, y = make_case(k, bs, seed, DEVICE, ones)
    dt = torch.bfloat16 if bf16 else torch.float32
    params, x = _cast(params, dt), x.to(dt)
    tol = BF16_RTOL if bf16 else KERNEL_RTOL
    print(f" case {label}: K={k} B={bs} {'bf16' if bf16 else 'f32'}")
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
    if bf16:
        chk.windows("conv_pool_fwd_k", r1k[1], r1[1])
        chk.windows("conv_pool_fwd_k", r2k[1], r2[1])

    flat = a2.reshape(k, bs, -1)
    logits_k, (h1k, h2k) = knl.fc_chain_fwd_k(flat, params)
    logits, (h1, h2) = ref.fc_chain_fwd_k(flat, params)
    chk.close("fc_chain_fwd_k", "logits", logits_k, logits, rtol=tol)
    chk.close("fc_chain_fwd_k", "h1", h1k, h1, rtol=tol)
    chk.close("fc_chain_fwd_k", "h2", h2k, h2, rtol=tol)

    onehot = torch.nn.functional.one_hot(y, 10).float()
    g = ((torch.softmax(logits.float(), -1) - onehot) / bs).to(dt)
    gk, dflat_k = knl.fc_chain_bwd_k(flat, (h1, h2), params, g)
    gp, dflat = ref.fc_chain_bwd_k(flat, (h1, h2), params, g)
    for layer in ("fc1", "fc2", "fc3"):
        for leaf in ("w", "b"):
            chk.close("fc_chain_bwd_k", f"d{layer}.{leaf}", gk[layer][leaf],
                      gp[layer][leaf], rtol=tol)
    chk.close("fc_chain_bwd_k", "dflat", dflat_k, dflat, rtol=tol)

    da2 = dflat.reshape(a2.shape)
    for nm, res, w, da, need_dx in (("conv2", r2, p2["w"], da2, True),
                                    ("conv1", r1, p1["w"], None, False),
                                    ("conv1+dx", r1, p1["w"], None, True)):
        if da is None:
            da = (torch.randn(a1.shape, generator=torch.Generator(
                DEVICE).manual_seed(seed), device=DEVICE) * 1e-2).to(dt)
        outk = knl.conv_pool_bwd_k(res, w, da, need_dx)
        outp = ref.conv_pool_bwd_k(res, w, da, need_dx)
        for part, gk_, gp_ in zip(("dw", "db", "dx"), outk, outp):
            if gp_ is not None:
                # dw, db: f32 sums of the same products (summation order)
                chk.close("conv_pool_bwd_k", f"{nm} {part}", gk_, gp_,
                          rtol=tol if part == "dx" else KERNEL_RTOL)

    if ones or bf16:
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


def check_single(chk: Check, label: str, seed: int, ones: bool = False,
                 bf16: bool = False):
    """The four single-user kernels on one user of batch 10 (the main
    path's per-user shape) against their twins, and bit for bit against
    the blocked kernels at K=1: the same device code and summation order.
    The conv forward equals its twin exactly at both dtypes."""
    import torch
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x, y = make_case(1, 10, seed, DEVICE, ones)
    dt = torch.bfloat16 if bf16 else torch.float32
    params, x = _cast(params, dt), x.to(dt)
    tol = BF16_RTOL if bf16 else KERNEL_RTOL
    print(f" case {label}: one user, B=10 {'bf16' if bf16 else 'f32'}")
    p = {s: {n: t[0] for n, t in params[s].items()} for s in params}

    def same(name, what, got, blocked):
        if not torch.equal(got, blocked):
            raise AssertionError(f"{name} {what}: single-user kernel differs "
                                 "from the blocked kernel at K=1")

    inp = x[0]
    acts = []
    for layer in ("conv1", "conv2"):
        w, b = p[layer]["w"], p[layer]["b"]
        ak, rk = knl.conv_pool_fwd(inp, w, b)
        ap, rp = ref.conv_pool_fwd(inp, w, b)
        ab, rb = knl.conv_pool_fwd_k(inp[None], w[None], b[None])
        for nm, gk, gp, gb in zip(("a", "pat", "eq", "relu_m"), (ak, *rk),
                                  (ap, *rp), (ab, *rb)):
            chk.close("conv_pool_fwd", f"{layer} {nm}", gk, gp, exact=True)
            same("conv_pool_fwd", f"{layer} {nm}", gk, gb[0])
        if bf16:
            chk.windows("conv_pool_fwd", rk[1], rp[1])
        acts.append((ap, rp, w))
        inp = ap
    flat = inp.reshape(10, -1)
    lk, rk = knl.fc_chain_fwd(flat, p)
    lp, rp = ref.fc_chain_fwd(flat, p)
    lb, rb = knl.fc_chain_fwd_k(flat[None], _lead(p))
    for nm, gk, gp, gb in zip(("logits", "h1", "h2"), (lk, *rk), (lp, *rp),
                              (lb, *rb)):
        chk.close("fc_chain_fwd", nm, gk, gp, rtol=tol)
        same("fc_chain_fwd", nm, gk, gb[0])
    onehot = torch.nn.functional.one_hot(y[0], 10).float()
    g = ((torch.softmax(lp.float(), -1) - onehot) / 10).to(dt)
    gk, dk = knl.fc_chain_bwd(flat, rp, p, g)
    gp, dp = ref.fc_chain_bwd(flat, rp, p, g)
    gb, db = knl.fc_chain_bwd_k(flat[None], tuple(r[None] for r in rp),
                                _lead(p), g[None])
    chk.close("fc_chain_bwd", "dflat", dk, dp, rtol=tol)
    same("fc_chain_bwd", "dflat", dk, db[0])
    for layer in ("fc1", "fc2", "fc3"):
        for leaf in ("w", "b"):
            chk.close("fc_chain_bwd", f"d{layer}.{leaf}", gk[layer][leaf],
                      gp[layer][leaf], rtol=tol)
            same("fc_chain_bwd", f"d{layer}.{leaf}", gk[layer][leaf],
                 gb[layer][leaf][0])
    da = dp.reshape(acts[1][0].shape)
    for (a_out, res, w), layer, need_dx in ((acts[1], "conv2", True),
                                            (acts[0], "conv1", False)):
        outk = knl.conv_pool_bwd(res, w, da, need_dx)
        outp = ref.conv_pool_bwd(res, w, da, need_dx)
        outb = knl.conv_pool_bwd_k(tuple(r[None] for r in res), w[None],
                                   da[None], need_dx)
        for part, gk_, gp_, gb_ in zip(("dw", "db", "dx"), outk, outp, outb):
            if gp_ is None:
                continue
            chk.close("conv_pool_bwd", f"{layer} {part}", gk_, gp_,
                      rtol=tol if part == "dx" else KERNEL_RTOL)
            same("conv_pool_bwd", f"{layer} {part}", gk_, gb_[0])
        if need_dx:
            da = outp[2]


def _lead(p):
    return {s: {n: t[None] for n, t in p[s].items()} for s in p}


def nbytes(*ts) -> int:
    return sum(int(t.numel()) * t.element_size() for t in ts
               if t is not None)


def time_kernels(k: int = 10, bs: int = 10, seed: int = 0,
                 bf16: bool = False, user: bool = False) -> dict:
    """Kernel vs twin time per training step at the main path's shapes
    (both conv layers for the conv kernels), with bytes/operations bounds.
    ``user`` times the single-user kernels: one call per user slot, K
    calls per layer and step, the same work in all.  ``bf16`` times the
    bf16 instantiations."""
    import torch
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    dt = torch.bfloat16 if bf16 else torch.float32
    params, x, y = make_case(k, bs, seed, DEVICE)
    params, x = _cast(params, dt), x.to(dt)
    p1, p2 = params["conv1"], params["conv2"]
    a1, r1 = ref.conv_pool_fwd_k(x, p1["w"], p1["b"])
    a2, r2 = ref.conv_pool_fwd_k(a1, p2["w"], p2["b"])
    flat = a2.reshape(k, bs, -1)
    logits, rfc = ref.fc_chain_fwd_k(flat, params)
    g = ((torch.softmax(logits.float(), -1)
          - torch.nn.functional.one_hot(y, 10).float()) / bs).to(dt)
    gfc, dflat = ref.fc_chain_bwd_k(flat, rfc, params, g)
    da2 = dflat.reshape(a2.shape)
    dw2, db2, da1 = ref.conv_pool_bwd_k(r2, p2["w"], da2, True)
    dw1, db1, _ = ref.conv_pool_bwd_k(r1, p1["w"], da1, False)
    fcw = [params[n][t] for n in ("fc1", "fc2", "fc3") for t in ("w", "b")]

    if user:
        # per-user views, sliced once outside the timed loops
        ux = [(x[i], a1[i], p1["w"][i], p1["b"][i], p2["w"][i],
               p2["b"][i]) for i in range(k)]
        ub = [(tuple(r[i] for r in r1), tuple(r[i] for r in r2),
               p1["w"][i], p2["w"][i], da1[i], da2[i]) for i in range(k)]
        up = [{s_: {n: t[i] for n, t in params[s_].items()}
               for s_ in params} for i in range(k)]
        uf = [(flat[i], tuple(r[i] for r in rfc), g[i]) for i in range(k)]

        def conv_fwd(mod):
            for xi, ai, w1, b1, w2, b2 in ux:
                mod.conv_pool_fwd(xi, w1, b1)
                mod.conv_pool_fwd(ai, w2, b2)

        def conv_bwd(mod):
            for q1, q2, w1, w2, d1, d2 in ub:
                mod.conv_pool_bwd(q2, w2, d2, True)
                mod.conv_pool_bwd(q1, w1, d1, False)

        def fc_fwd(mod):
            for (fi, _, _), pi in zip(uf, up):
                mod.fc_chain_fwd(fi, pi)

        def fc_bwd(mod):
            for (fi, ri, gi), pi in zip(uf, up):
                mod.fc_chain_bwd(fi, ri, pi, gi)
    else:
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
    sfx = "" if user else "_k"
    work = {   # (bytes moved once, operations) per training step
        "conv_pool_fwd": (
            nbytes(x, p1["w"], p1["b"], a1, *r1, a1, p2["w"], p2["b"], a2,
                   *r2),
            conv_flops(x, p1["w"]) + conv_flops(a1, p2["w"])),
        "conv_pool_bwd": (
            nbytes(*r2, p2["w"], da2, dw2, db2, da1, *r1, p1["w"], da1, dw1,
                   db1),
            2 * conv_flops(a1, p2["w"]) + conv_flops(x, p1["w"])),
        "fc_chain_fwd": (nbytes(flat, *fcw, logits, *rfc), fc_flops),
        "fc_chain_bwd": (nbytes(flat, *rfc, *fcw[::2], g, *[
            gfc[n][t] for n in ("fc1", "fc2", "fc3") for t in ("w", "b")],
            dflat), 2 * fc_flops),
    }
    fns = {"conv_pool_fwd": conv_fwd, "conv_pool_bwd": conv_bwd,
           "fc_chain_fwd": fc_fwd, "fc_chain_bwd": fc_bwd}
    out = {}
    for name, fn in fns.items():
        iters = 10 if user else 50
        split = device_split(lambda: fn(knl), iters=iters)
        ms = sum(split.values())
        if name in ("fc_chain_fwd", "fc_chain_bwd"):
            for fn_name, f_ms in split.items():
                print(f"  {name + sfx:16s} {'bf16' if bf16 else 'f32 '} per "
                      f"step, __global__ {short_name(fn_name)}: "
                      f"{f_ms * 1e3:8.2f} us")
        plain = device_ms(lambda: fn(ref), iters=2 if user else 10)
        wall = cuda_ms(lambda: fn(knl), iters=4 * iters)
        b_ms, by = bound_ms(*work[name])
        out[name + sfx] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": by, "wall_ms": wall}
        print(f"  {name + sfx:16s} {'bf16' if bf16 else 'f32 '} per step: "
              f"kernel {ms * 1e3:9.2f} us  twin {plain * 1e3:9.2f} us  "
              f"bound {b_ms * 1e3:6.2f} us ({by}, {work[name][0] / 1e6:.2f} "
              f"MB, {work[name][1] / 1e6:.1f} MFLOP)  back-to-back wall "
              f"{wall * 1e3:9.2f} us")
    if user or bf16:
        return out

    # eval shape (K=1, B=1000): forward kernels without residuals
    p0 = {s_: {n: t[:1].contiguous() for n, t in params[s_].items()}
          for s_ in params}
    xe = make_case(1, 1000, seed + 100, DEVICE)[1]
    ae, _ = ref.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"], False)
    ae2, _ = ref.conv_pool_fwd_k(ae, p0["conv2"]["w"], p0["conv2"]["b"],
                                 False)

    def eval_conv(mod):
        mod.conv_pool_fwd_k(xe, p0["conv1"]["w"], p0["conv1"]["b"], False)
        mod.conv_pool_fwd_k(ae, p0["conv2"]["w"], p0["conv2"]["b"], False)

    def eval_fc(mod):
        mod.fc_chain_fwd_k(ae2.reshape(1, 1000, -1), p0)

    for label, fn in (("conv_pool_fwd_k", eval_conv),
                      ("fc_chain_fwd_k", eval_fc)):
        ms = device_ms(lambda: fn(knl), iters=20)
        plain = device_ms(lambda: fn(ref), iters=3)
        print(f"  {label:16s} eval (K=1,B=1000): kernel {ms * 1e3:9.2f} us  "
              f"twin {plain * 1e3:9.2f} us")
    return out


def codec_input(m: int, block: int, bits: int, seed: int):
    """Gaussian rows (deltas of ~1e-3), all-zero rows (row padding,
    unchanged users) and rows whose lanes sit on exact k + 0.5 quanta of a
    power-of-two scale, where rounding half to even shows."""
    import torch
    g = torch.Generator().manual_seed(seed)
    qmax = 2 ** (bits - 1) - 1
    x = torch.randn((m, block), generator=g) * 1e-3
    ties = list(range(3, m, 11))
    zeros = [r for r in range(0, m, 7) if r not in set(ties)]
    x[zeros] = 0.0
    for r in ties:
        sc = 2.0 ** -(8 + r % 5)
        k = torch.randint(-qmax, qmax, (block - 1,), generator=g).float()
        x[r, 0] = qmax * sc
        x[r, 1:] = (k + 0.5) * sc
    return x.to(DEVICE), zeros, ties


def check_codec(chk: Check):
    """Both codec kernels vs their twins on the card, bitwise, over the
    shapes the paths use; the tie rows must round half to even."""
    import torch
    from repro_torch.kernels.delta_codec import kernel as knl, ref
    for m in (2560, 217):
        for block in (512, 128):
            for bits in (8, 4):
                x, zeros, ties = codec_input(m, block, bits,
                                             m + block + bits)
                label = f"M={m} block={block} int{bits}"
                q, sc = knl.quantize_blocks(x, bits=bits)
                qr, sr = ref.quantize_ref(x, bits)
                chk.close("quantize_blocks", f"{label} q", q, qr, exact=True)
                chk.close("quantize_blocks", f"{label} scales", sc, sr,
                          exact=True)
                d = knl.dequantize_blocks(qr, sr)
                chk.close("dequantize_blocks", f"{label} x", d,
                          ref.dequantize_ref(qr, sr), exact=True)
                quot = x[ties, 1:] / sr[ties]
                if not (bool(torch.all(quot - torch.floor(quot) == 0.5))
                        and bool(torch.all(q[ties, 1:] % 2 == 0))
                        and bool(torch.all(sr[zeros] == 1e-12))):
                    raise AssertionError(f"codec {label}: ties or zero rows "
                                         "not as constructed")


def time_codec(m: int = 2560, block: int = 512, bits: int = 8) -> dict:
    """Codec kernel vs twin vs library call at the fused round's shape."""
    import torch
    from repro_torch.kernels.delta_codec import kernel as knl, ref
    x = torch.randn((m, block), device=DEVICE) * 1e-3
    q, sc = ref.quantize_ref(x, bits)
    nbytes = 4 * numel(x) + numel(q) + 4 * numel(sc)   # same for both
    runs = {
        "quantize_blocks": (lambda: knl.quantize_blocks(x, bits=bits),
                            lambda: ref.quantize_ref(x, bits), None,
                            # abs, max, multiply, divide, round, clip
                            6.0 * m * block),
        "dequantize_blocks": (lambda: knl.dequantize_blocks(q, sc),
                              lambda: ref.dequantize_ref(q, sc),
                              lambda: torch.mul(q, sc), 2.0 * m * block),
    }
    out = {}
    for name, (kern, plain, lib, ops) in runs.items():
        ms = device_ms(kern, iters=200)
        plain_ms = device_ms(plain, iters=50)
        lib_ms = None if lib is None else device_ms(lib, iters=200)
        wall = cuda_ms(kern, iters=500)
        b_ms, by = bound_ms(nbytes, ops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib_ms, "wall_ms": wall}
        print(f"  {name:17s} M={m} block={block} int{bits}: kernel "
              f"{ms * 1e3:8.2f} us  twin {plain_ms * 1e3:8.2f} us  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:8.2f} us'}  "
              f"bound {b_ms * 1e3:6.2f} us ({by}, {nbytes / 1e6:.2f} MB)  "
              f"back-to-back wall {wall * 1e3:8.2f} us")
    # one tree (the host engine's and the server's snapshots)
    x1 = torch.randn((217, block), device=DEVICE) * 1e-3
    q1, s1 = ref.quantize_ref(x1, bits)
    print(f"  one tree (217 rows): quantize "
          f"{device_ms(lambda: knl.quantize_blocks(x1, bits=bits), 200) * 1e3:.2f}"
          f" us, dequantize "
          f"{device_ms(lambda: knl.dequantize_blocks(q1, s1), 200) * 1e3:.2f}"
          f" us")
    return out


# ---------------------------------------------------------------------------
# phases 4 to 6: the paths
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
    """Kernel launches the rounds need: every trained round runs e·S steps
    (2 conv fwd, 2 conv bwd, 1 fc fwd, 1 fc bwd calls each), and every eval
    2 conv fwd + 1 fc fwd calls; with the codec every trained round
    quantizes once per probe epoch and dequantizes once (probing
    schemes)."""
    from repro_torch.core.schemes import get_scheme
    trained = sum(1 for r in rows if r[0] > 0)
    steps = trained * cfg.local_epochs * cfg.steps_per_epoch
    evals = len(rows)
    calls = {"conv_pool_fwd_k": 2 * steps + 2 * evals,
             "conv_pool_bwd_k": 2 * steps,
             "fc_chain_fwd_k": steps + evals,
             "fc_chain_bwd_k": steps}
    out = {n: c * LAUNCHES_PER_CALL[n] for n, c in calls.items()}
    out.update(dict.fromkeys(USER_CNN, 0))
    scheme = get_scheme(cfg.scheme)
    probes = len(scheme.static_schedule(cfg.local_epochs, cfg.b,
                                        cfg.schedule_override))
    codec = cfg.use_delta_codec
    out["quantize_blocks"] = trained * probes if codec else 0
    out["dequantize_blocks"] = trained if codec and scheme.uses_probes \
        else 0
    return out


def reset_all_launches():
    from repro_torch.kernels.delta_codec import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_cnn import kernel as fk
    from repro_torch.kernels.wkv6 import kernel as wk
    for mod in (fk, dk, fa, wk):
        mod.reset_launches()


def bf16_launches() -> dict:
    from repro_torch.kernels.fused_cnn import kernel as fk
    return dict(fk.LAUNCHES_BF16)


def all_launches() -> dict:
    from repro_torch.kernels.delta_codec import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_cnn import kernel as fk
    from repro_torch.kernels.wkv6 import kernel as wk
    return {**fk.LAUNCHES, **dk.LAUNCHES, **fa.LAUNCHES, **wk.LAUNCHES}


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
    """Paper-config fused rounds on the card for every registered scheme,
    and opt with the delta codec; returns the launch counts of this run."""
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.core.schemes import registered_schemes
    runs = [("opt", 5, False), ("opt", 5, True)] + [
        (s, 2, False) for s in registered_schemes() if s != "opt"]
    want = {n: 0 for n in REPLACES}
    reset_all_launches()
    for scheme, rounds, codec in runs:
        b = 2 if scheme in ("opt", "deadline") or scheme.startswith("opt_") \
            else 1
        cfg = HSFLConfig(rounds=rounds, scheme=scheme, b=b,
                         use_delta_codec=codec)
        label = f"{scheme}(b={b}{', codec' if codec else ''})"
        sim, rows, times = run_rounds(cfg, DEVICE)
        print_rounds(label, rows, times)
        if not params_finite(sim.params):
            raise AssertionError(f"{label}: non-finite params")
        for n, c in expected_launches(cfg, rows).items():
            want[n] += c
        if scheme == "opt" and not rows[-1][7] > 0.1:
            raise AssertionError(f"{label} accuracy {rows[-1][7]} is not "
                                 "above chance (0.1) after 5 rounds")
        if scheme == "opt":
            steady = times[1:]
            print(f"  {label} ms/round (rounds 2-5): median "
                  f"{float(np.median(steady)):.1f}, min {min(steady):.1f}")
    got = all_launches()
    print(f"  launches: {got}")
    if got != want:
        raise AssertionError(f"launch counts {got} != expected {want}")
    if min(got[n] for n in FUSED_CNN + CODEC) <= 0:
        raise AssertionError("a kernel of the fused path never launched")
    if bf16_launches() != dict.fromkeys(bf16_launches(), 0):
        raise AssertionError("the f32 fused path launched a bf16 kernel")
    return got


POLICIES = (("bf16", {"precision": "bf16"}),
            ("single f32", {"batch_users": False}),
            ("single bf16", {"batch_users": False, "precision": "bf16"}),
            ("im2col f32", {"kernel": "im2col"}),
            ("im2col bf16", {"kernel": "im2col", "precision": "bf16"}))


def expected_policy_launches(cfg, rows) -> dict:
    """Fused-CNN launches the rounds of one policy need: every eval runs
    the f32 blocked forward kernels at K=1 (2 conv fwd + 1 fc fwd calls);
    every trained round runs e·S steps, each through the blocked kernels
    (2 conv fwd, 2 conv bwd, 1 fc fwd, 1 fc bwd calls), or with
    ``batch_users=False`` through the single-user kernels once per user
    slot (K slots: the selected users padded to an even bucket), or with
    im2col through no kernel.  Returns (all launches, bf16 launches)."""
    from repro_torch.core.hsfl import _k_bucket
    steps = cfg.local_epochs * cfg.steps_per_epoch
    calls = dict.fromkeys(FUSED_CNN + USER_CNN, 0)
    calls["conv_pool_fwd_k"] = 2 * len(rows)
    calls["fc_chain_fwd_k"] = len(rows)
    train = dict.fromkeys(FUSED_CNN + USER_CNN, 0)
    for r in rows:
        if r[0] == 0 or cfg.kernel == "im2col":
            continue
        slots = 1 if cfg.batch_users else _k_bucket(r[0], cfg.k_select)
        sfx = "_k" if cfg.batch_users else ""
        for n, per in (("conv_pool_fwd", 2), ("conv_pool_bwd", 2),
                       ("fc_chain_fwd", 1), ("fc_chain_bwd", 1)):
            train[n + sfx] += per * slots * steps
    bf = cfg.precision == "bf16"
    want = {n: (calls[n] + train[n]) * LAUNCHES_PER_CALL[n] for n in calls}
    want_bf = {n: (train[n] if bf else 0) * LAUNCHES_PER_CALL[n]
               for n in calls}
    return want, want_bf


def policy_path(rounds: int = 5):
    """Opt (b=2) rounds at the paper config under each new policy; returns
    the launch counts of the single-user kernels and the bf16 launches of
    every fused-CNN kernel over the phase, and the median round ms per
    policy."""
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.kernels.fused_cnn import kernel as fk
    total = dict.fromkeys(FUSED_CNN + USER_CNN, 0)
    total_bf = dict.fromkeys(FUSED_CNN + USER_CNN, 0)
    medians = {}
    for label, kw in POLICIES:
        cfg = HSFLConfig(rounds=rounds, scheme="opt", b=2, **kw)
        reset_all_launches()
        sim, rows, times = run_rounds(cfg, DEVICE)
        got = {n: fk.LAUNCHES[n] for n in total}
        got_bf = {n: fk.LAUNCHES_BF16[n] for n in total}
        print_rounds(label, rows, times)
        medians[label] = float(np.median(times[1:]))
        print(f"  {label}: ms/round (rounds 2-{rounds}) median "
              f"{medians[label]:.1f}, min {min(times[1:]):.1f}; launches "
              f"{got}; bf16 {got_bf}")
        if not params_finite(sim.params):
            raise AssertionError(f"{label}: non-finite params")
        if not rows[-1][7] > 0.1:
            raise AssertionError(f"{label}: accuracy {rows[-1][7]} is not "
                                 f"above chance (0.1) after {rounds} rounds")
        want, want_bf = expected_policy_launches(cfg, rows)
        if got != want or got_bf != want_bf:
            raise AssertionError(f"{label}: launches {got} / bf16 {got_bf} "
                                 f"!= expected {want} / {want_bf}")
        for n in total:
            total[n] += got[n]
            total_bf[n] += got_bf[n]
    if min(total[n] for n in USER_CNN) <= 0 or \
            min(total_bf.values()) <= 0:
        raise AssertionError("a single-user kernel or a bf16 instantiation "
                             "never launched on the policy path")
    return total, total_bf, medians


def device_busy_share(**kw):
    """Share of one steady opt round's wall time the card spends in
    kernels, from torch.profiler; None when the profiler sees no device
    time.  ``kw`` sets the round's policy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    sim = HSFLSimulation(HSFLConfig(rounds=2, scheme="opt", b=2, **kw),
                         DEVICE)
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
    print(f"  profiler: one opt round + eval {kw or ''}: wall "
          f"{wall * 1e3:.1f} ms, "
          f"device busy {dev_us / 1e3:.2f} ms -> busy share {share:.3f}, "
          f"idle share {1 - share:.3f}")
    print_top_kernels(prof, 12)
    return share


SERVE_FAULTS = "dup@r1:c*; corrupt@r2:c*; crash@r3:checkpoint"


def final_params(ckpt_dir: str):
    """The params of the newest committed checkpoint of an opt server."""
    from repro_torch.checkpoint.msgpack_ckpt import (latest_step,
                                                     restore_checkpoint)
    from repro_torch.models.cnn import init_cnn
    step = latest_step(ckpt_dir)
    like = {"params": init_cnn(0, DEVICE), "delayed": [],
            "fleet_pos": np.zeros((30, 3)), "fleet_kdb": np.zeros(30),
            "fleet_bad": np.zeros(30, bool)}
    return step, restore_checkpoint(ckpt_dir, step, like)["params"]


def serving_path(rounds: int = 4):
    """The codec server at the paper config through the launcher: (a)
    faults and a crash under the supervisor, (b) no faults, (c) the host
    engine alone; all three must end with equal params.  Returns the codec
    launches of this run and the ms per round of (b) and (c)."""
    import torch
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    from repro_torch.launch import serve_fl
    from repro_torch.utils.tree import tree_leaves
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    args = ["--device", DEVICE, "--codec", "--rounds", str(rounds),
            "--quiet"]
    reset_all_launches()
    params, ms = {}, {}
    for label, extra in (("a", ["--faults", SERVE_FAULTS]), ("b", [])):
        d = os.path.join(CKPT_DIR, label)
        sync()
        t0 = time.perf_counter()
        rc = serve_fl.main(args + ["--ckpt-dir", d] + extra)
        sync()
        ms[label] = (time.perf_counter() - t0) * 1e3 / rounds
        step, params[label] = final_params(d)
        if rc != 0 or step != rounds:
            raise AssertionError(f"serve_fl ({label}) returned {rc}, "
                                 f"last committed step {step}")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            for row in map(json.loads, f):
                print(f"  ({label}) round {row['round']}: arrived="
                      f"{row['arrived_final']} rescued={row['used_snapshot']}"
                      f" dropped={row['dropped']} dup_rejected="
                      f"{row['duplicates_rejected']} corrupt_rejected="
                      f"{row['corrupt_rejected']} retries={row['retries']} "
                      f"bytes={row['bytes_sent']:.0f} test_acc="
                      f"{row['test_acc']:.4f}")
    sim = HSFLSimulation(HSFLConfig(rounds=rounds, use_delta_codec=True,
                                    use_fused_round=False), DEVICE)
    times = []
    for t in range(1, rounds + 1):
        sync()
        t0 = time.perf_counter()
        sim.run_round(t, [])
        sim.evaluate()
        times.append((time.perf_counter() - t0) * 1e3)
    ms["c"] = float(np.median(times[1:]))
    params["c"] = sim.params
    got = {n: all_launches()[n] for n in CODEC}
    print(f"  (a) faults {SERVE_FAULTS!r} under the supervisor: "
          f"{ms['a']:.1f} ms/round (restart and replay included); (b) no "
          f"faults: {ms['b']:.1f} ms/round; (c) host engine: rounds "
          + ", ".join(f"{x:.1f}" for x in times) + " ms")
    print(f"  codec launches over (a)-(c): {got}")
    for other in ("b", "c"):
        for x, y in zip(tree_leaves(params["a"]), tree_leaves(params[other])):
            if not torch.equal(x, y):
                raise AssertionError(f"serving (a) and ({other}) params "
                                     "differ")
    print("  final params of (a), (b) and (c) are equal bit for bit")
    if not params_finite(params["a"]):
        raise AssertionError("serving: non-finite params")
    if min(got.values()) <= 0:
        raise AssertionError("a codec kernel never launched on the serving "
                             "path")
    return got, ms


def serving_busy_share():
    """Wall time and device busy share of one steady server round (train,
    probes through the codec, msgpack uploads, aggregation, eval)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.serving.fl_server import FLServer
    server = FLServer(HSFLConfig(rounds=3, use_delta_codec=True), device=DEVICE)
    server.step()
    sync()
    t0 = time.perf_counter()
    server.step()
    sync()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.step()
        sync()
        wall = time.perf_counter() - t0
    dev_us = _device_us(prof)
    if dev_us <= 0:
        print("  profiler: no device time recorded (busy share not measured)")
        return wall_plain * 1e3, None
    share = dev_us / 1e6 / wall
    print(f"  server round 2: wall {wall_plain * 1e3:.1f} ms; round 3 under "
          f"the profiler: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms -> busy share {share:.3f}, idle share "
          f"{1 - share:.3f}")
    print_top_kernels(prof, 10)
    return wall_plain * 1e3, share


class ScaleSpy:
    """Records the largest scale the codec produces while active (the
    quantization step that bounds a .5-boundary flip)."""

    def __enter__(self):
        from repro_torch.core import fused_round
        from repro_torch.kernels.delta_codec import ops
        self.mods, self.orig, self.max = (fused_round, ops), \
            ops.quantize_blocks, 0.0

        def spy(x, bits=8):
            q, sc = self.orig(x, bits=bits)
            self.max = max(self.max, float(sc.max()))
            return q, sc

        for mod in self.mods:
            mod.quantize_blocks = spy
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.quantize_blocks = self.orig


def compare(label: str, rows_g, rows_c, params_g, params_c, tol: float,
            n_test: int, frob: bool = False, images: int = 1):
    """Equal counts; params within ``tol`` (max abs, or with ``frob`` the
    largest relative Frobenius error of a leaf); accuracy within
    ``images`` test images."""
    from repro_torch.utils.tree import tree_leaves
    print_rounds(f"{label} card", rows_g, [0.0] * len(rows_g))
    print_rounds(f"{label} cpu ", rows_c, [0.0] * len(rows_c))
    if [r[:6] for r in rows_g] != [r[:6] for r in rows_c]:
        raise AssertionError(f"{label}: card and CPU counts differ")
    pairs = [(g.cpu().double(), c.double()) for g, c in zip(
        tree_leaves(params_g), tree_leaves(params_c))]
    if frob:
        errs = [float((g - c).norm() / c.norm()) for g, c in pairs]
        print(f"  {label}: relative Frobenius per leaf "
              + ", ".join(f"{e:.2e}" for e in errs) + " (tree order)")
        diff = max(errs)
        what = "max relative Frobenius |param card - param cpu|"
    else:
        diff = max(float((g - c).abs().max()) for g, c in pairs)
        what = "max |param card - param cpu|"
    dacc = max(abs(g[7] - c[7]) for g, c in zip(rows_g, rows_c))
    print(f"  {label}: {what} = {diff:.3e} (tol {tol:.3e}); max |acc diff| "
          f"= {dacc:.4f} (tol {images / n_test})")
    if not diff <= tol:
        raise AssertionError(f"{label}: card vs CPU params differ by {diff}")
    if not dacc <= images / n_test + 1e-9:
        raise AssertionError(f"{label}: card vs CPU accuracy differs by "
                             f"{dacc}")


def serve_rows(cfg, device, p0):
    """``cfg.rounds`` rounds of the server from params p0."""
    from repro_torch.serving.fl_server import FLServer
    from repro_torch.utils.tree import tree_map
    server = FLServer(cfg, device=device)
    server.sim.params = tree_map(lambda t: t.to(server.sim.device).clone(),
                                 p0)
    log = server.serve()
    return server.params, [(r.selected, r.arrived_final, r.used_snapshot,
                            r.delayed, r.dropped, r.bytes_sent, r.test_loss,
                            r.test_acc) for r in log.rounds]


def card_vs_cpu():
    """2 rounds from one seed and one set of params on the card and on the
    CPU, for the fused opt round, the fused codec round and the codec
    server: identical counts, params within PARAM_ATOL (plus one
    quantization step with the codec), accuracy within one test image."""
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.models.cnn import init_cnn
    cfg = HSFLConfig(rounds=2, scheme="opt", b=2)
    p0 = init_cnn(cfg.seed, "cpu")
    sim_g, rows_g, _ = run_rounds(cfg, DEVICE, p0)
    sim_c, rows_c, _ = run_rounds(cfg, "cpu", p0)
    compare("fused", rows_g, rows_c, sim_g.params, sim_c.params, PARAM_ATOL,
            cfg.n_test)
    cfg = HSFLConfig(rounds=2, scheme="opt", b=2, use_delta_codec=True)
    with ScaleSpy() as spy:
        sim_g, rows_g, _ = run_rounds(cfg, DEVICE, p0)
        sim_c, rows_c, _ = run_rounds(cfg, "cpu", p0)
    compare("fused codec", rows_g, rows_c, sim_g.params, sim_c.params,
            PARAM_ATOL + spy.max, cfg.n_test)
    with ScaleSpy() as spy:
        par_g, rows_g = serve_rows(cfg, DEVICE, p0)
        par_c, rows_c = serve_rows(cfg, "cpu", p0)
    compare("server codec", rows_g, rows_c, par_g, par_c,
            PARAM_ATOL + spy.max, cfg.n_test)
    # one round under bf16 (blocked kernels) and one through the
    # single-user kernels at f32
    cfg = HSFLConfig(rounds=1, scheme="opt", b=2, precision="bf16")
    sim_g, rows_g, _ = run_rounds(cfg, DEVICE, p0)
    sim_c, rows_c, _ = run_rounds(cfg, "cpu", p0)
    compare("fused bf16", rows_g, rows_c, sim_g.params, sim_c.params,
            BF16_FROB, cfg.n_test, frob=True, images=3)
    cfg = HSFLConfig(rounds=1, scheme="opt", b=2, batch_users=False)
    sim_g, rows_g, _ = run_rounds(cfg, DEVICE, p0)
    sim_c, rows_c, _ = run_rounds(cfg, "cpu", p0)
    compare("fused single-user", rows_g, rows_c, sim_g.params, sim_c.params,
            PARAM_ATOL, cfg.n_test)


# ---------------------------------------------------------------------------
# phase 8: the model zoo's inference path
# ---------------------------------------------------------------------------

# kernel vs twin in the zoo, relative to the largest magnitude: f32 as the
# fused CNN (summation order only); bf16 outputs are rounded once from f32
# values that differ by summation order, so by at most one bf16 ulp
ZOO_BF16_RTOL = 2 ** -7
# the zoo's forward at full width, kernel path (full-sequence forward) vs
# cache path (the token loop), last-position logits: at f32 the two sum in
# another order (1e-3 of the largest magnitude); at bf16 the cache path
# rounds the scores to bf16 before the softmax where the kernel keeps them
# in f32, and every layer's bf16 roundings compound: relative Frobenius
# error 5% (0.7% at the reduced size on the CPU, tests/test_torch_zoo.py)
ZOO_CACHE_F32_RTOL = 1e-3
ZOO_CACHE_BF16_FROB = 0.05
# card vs CPU at the reduced size, the CPU tests' bounds against JAX:
# f32 logits within 1e-4 of the largest magnitude, bf16 3% Frobenius
ZOO_CPU_F32_RTOL = 1e-4
ZOO_CPU_BF16_FROB = 0.03
# the zoo's cells: Llama-3.2-1B as configured, RWKV6-7B at full width with
# the depth cut to 4 of its 32 layers; prompts of B x S tokens
ZOO_B, ZOO_S = 2, 2048
# hubert-xlarge's attention (configs/hubert_xlarge.py): 16 q and 16 kv
# heads of D=80, bidirectional, over the 1500 frames of 30 s of audio
HUBERT_S = 1500
RWKV_LAYERS = 4
CACHE_PROMPT = 256


def zoo_configs(reduced: bool = False):
    """(Llama-3.2-1B, RWKV6-7B cut to RWKV_LAYERS layers), or their
    reduced variants, llama with 2 kv heads (phase 8e)."""
    from repro_torch.configs import get_config
    llama, rwkv = get_config("llama3.2-1b"), get_config("rwkv6-7b")
    if reduced:
        return llama.reduced().replace(num_kv_heads=2), rwkv.reduced()
    return llama, rwkv.replace(num_layers=RWKV_LAYERS)


def flash_inputs(b, h, kv, sq, sk, d, dtype, seed):
    import torch
    g = torch.Generator(DEVICE).manual_seed(seed)
    q = torch.randn(b * h, sq, d, device=DEVICE, generator=g).to(dtype)
    k = torch.randn(b * kv, sk, d, device=DEVICE, generator=g).to(dtype)
    v = torch.randn(b * kv, sk, d, device=DEVICE, generator=g).to(dtype)
    return q, k, v


def wkv_inputs(bh, s, d, dtype, seed):
    import torch
    g = torch.Generator(DEVICE).manual_seed(seed)
    r, k, v = (torch.randn(bh, s, d, device=DEVICE, generator=g).mul(0.5)
               .to(dtype) for _ in range(3))
    w = torch.rand(bh, s, d, device=DEVICE, generator=g) * 0.4 + 0.55
    u = torch.randn(bh, d, device=DEVICE, generator=g) * 0.1
    return r, k, v, w, u


def check_zoo_kernels(chk: Check, s: int = ZOO_S):
    """Both zoo kernels vs their twins on the card at the models' shapes:
    flash attention at Llama-3.2-1B's prefill (B=2, 32 q / 8 kv heads,
    D=64) causal, with a window of 256, non-causal, and a ragged S causal
    and not, each at bf16 and at f32 (whose tolerance a wrong mask on
    small rows could not pass), Sq < Sk, and at hubert-xlarge's (D=80);
    WKV6 at RWKV6-7B's (B=2 x 64
    heads, D=64) with r/k/v at bf16 and w in f32, and all f32, and at
    ragged S with D=32 and D=128 (y and the final state)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.wkv6 import kernel as wk, ref as wr
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("causal bf16", (ZOO_B, 32, 8, s, s, 64, True, 0, bf)),
             ("causal f32", (ZOO_B, 32, 8, s, s, 64, True, 0, f32)),
             ("window 256 bf16", (ZOO_B, 32, 8, s, s, 64, True, 256, bf)),
             ("window 256 f32", (ZOO_B, 32, 8, s, s, 64, True, 256, f32)),
             ("non-causal bf16", (ZOO_B, 32, 8, s, s, 64, False, 0, bf)),
             ("non-causal f32", (ZOO_B, 32, 8, s, s, 64, False, 0, f32)),
             (f"ragged S={s - 48} bf16",
              (ZOO_B, 32, 8, s - 48, s - 48, 64, True, 0, bf)),
             (f"ragged S={s - 48} f32",
              (ZOO_B, 32, 8, s - 48, s - 48, 64, True, 0, f32)),
             # the causal mask hides the zero-filled tail keys from every
             # real row: only without it does the tail mask show
             (f"ragged S={s - 48} non-causal bf16",
              (ZOO_B, 32, 8, s - 48, s - 48, 64, False, 0, bf)),
             (f"ragged S={s - 48} non-causal f32",
              (ZOO_B, 32, 8, s - 48, s - 48, 64, False, 0, f32)),
             ("Sq=100 < Sk=300 f32", (1, 4, 2, 100, 300, 64, True, 0, f32)),
             ("window 20 < tile, D=32 f32",
              (2, 4, 2, 128, 128, 32, True, 20, f32)),
             # hubert-xlarge: D=80 (the bf16 kernel's 128-wide
             # instantiation), non-causal, S=1500 ragged against every tile
             ("hubert-xlarge D=80 bf16",
              (ZOO_B, 16, 16, HUBERT_S, HUBERT_S, 80, False, 0, bf)),
             ("hubert-xlarge D=80 f32",
              (ZOO_B, 16, 16, HUBERT_S, HUBERT_S, 80, False, 0, f32))]
    for i, (label, (b, h, kv, sq, sk, d, causal, window, dt)) in \
            enumerate(cases):
        q, k, v = flash_inputs(b, h, kv, sq, sk, d, dt, seed=100 + i)
        got = fk.flash_attention_bh(q, k, v, group_size=h // kv,
                                    causal=causal, window=window)
        want = fr.flash_attention_bh_ref(q, k, v, h // kv, causal, window)
        chk.close("flash_attention_bh", label, got, want,
                  rtol=ZOO_BF16_RTOL if dt == bf else KERNEL_RTOL)
    for i, (label, (bh, sl, d, dt)) in enumerate(
            [("rwkv6-7b r/k/v bf16, w f32", (ZOO_B * 64, s, 64, bf)),
             ("rwkv6-7b all f32", (ZOO_B * 64, s, 64, f32)),
             ("ragged S=77, D=32 f32", (16, 77, 32, f32)),
             ("ragged S=300, D=128 bf16", (32, 300, 128, bf)),
             ("ragged S=300, D=128 f32", (32, 300, 128, f32))]):
        r, k, v, w, u = wkv_inputs(bh, sl, d, dt, seed=200 + i)
        y, sf = wk.wkv6_bh(r, k, v, w, u)
        yr, sr = wr.wkv6_bh_ref(r, k, v, w, u)
        chk.close("wkv6_bh", f"{label} y", y, yr,
                  rtol=ZOO_BF16_RTOL if dt == bf else KERNEL_RTOL)
        chk.close("wkv6_bh", f"{label} S_final", sf, sr)


def time_hubert_flash(dt, tag: str) -> dict:
    """flash attention at hubert-xlarge's shape (B=2, 16 + 16 heads, D=80,
    S=1500, non-causal) beside SDPA and its bound: 4 B H S^2 D operations
    (q.k and p.v over every pair, FMA = 2), 23.3 us in bf16 and 344 us in
    f32; keys of the kernel's row, prefixed d80_.  Both are timed with
    CUDA events over back-to-back calls: this late in the process the
    profiler may keep no record of a session at all."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    h, d, s = 16, 80, HUBERT_S
    q, k, v = flash_inputs(ZOO_B, h, h, s, s, d, dt, seed=9)
    o = fk.flash_attention_bh(q, k, v, causal=False)
    flops = 4.0 * ZOO_B * h * s * s * d
    rate = BF16_FLOPS_PER_S if tag == "bf16" else F32_FLOPS_PER_S
    b_ms, by = bound_ms(nbytes(q, k, v, o), flops, rate)
    qh, kh, vh = (t.reshape(ZOO_B, h, s, d) for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                  iters=20)
    ms = cuda_ms(lambda: fk.flash_attention_bh(q, k, v, causal=False),
                 iters=20)
    print(f"  flash_attention_bh {tag} hubert-xlarge B={ZOO_B} S={s} "
          f"H=KV={h} D={d} non-causal (CUDA events): kernel "
          f"{ms * 1e3:9.2f} us  SDPA "
          f"{lib * 1e3:8.2f} us  bound {b_ms * 1e3:6.2f} us ({by}, "
          f"{flops / 1e9:.2f} GFLOP); achieved: kernel "
          f"{flops / ms / 1e9:.1f} TFLOP/s, SDPA {flops / lib / 1e9:.1f} "
          f"TFLOP/s")
    return {"d80_ms": ms, "d80_bound_ms": b_ms, "d80_library_ms": lib}


def time_zoo_kernels() -> dict:
    """Each zoo kernel vs its twin, the library call where there is one,
    and the bound, at the main path's shapes (bf16, as the models run),
    and at f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.wkv6 import kernel as wk, ref as wr
    out = {}
    h, kv, d = 32, 8, 64
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = flash_inputs(ZOO_B, h, kv, ZOO_S, ZOO_S, d, dt, seed=7)
        o = fk.flash_attention_bh(q, k, v, group_size=h // kv)
        live = int(fr.live_mask(ZOO_S, ZOO_S, True, 0, DEVICE).sum())
        flops = 4.0 * d * live * ZOO_B * h          # q.k and p.v, FMA = 2
        rate = BF16_FLOPS_PER_S if tag == "bf16" else F32_FLOPS_PER_S
        b_ms, by = bound_ms(nbytes(q, k, v, o), flops, rate)
        # the library yardstick, never on the path: SDPA on the same
        # q/k/v in (B, H, S, D), kv heads repeated
        qh = q.reshape(ZOO_B, h, ZOO_S, d)
        kh = k.reshape(ZOO_B, kv, ZOO_S, d).repeat_interleave(h // kv, 1)
        vh = v.reshape(ZOO_B, kv, ZOO_S, d).repeat_interleave(h // kv, 1)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), iters=20)
        ms = device_ms(lambda: fk.flash_attention_bh(
            q, k, v, group_size=h // kv), iters=10)
        plain = device_ms(lambda: fr.flash_attention_bh_ref(
            q, k, v, h // kv), iters=3)
        out[tag] = {"flash_attention_bh": {
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib, **time_hubert_flash(dt, tag)}}
        print(f"  flash_attention_bh {tag} B={ZOO_B} S={ZOO_S} H={h} KV={kv} "
              f"D={d} causal: kernel {ms * 1e3:9.2f} us  twin "
              f"{plain * 1e3:9.2f} us  SDPA {lib * 1e3:8.2f} us  bound "
              f"{b_ms * 1e3:6.2f} us ({by}, {nbytes(q, k, v, o) / 1e6:.1f} "
              f"MB, {flops / 1e9:.1f} GFLOP); achieved: kernel "
              f"{flops / ms / 1e9:.1f} TFLOP/s, SDPA "
              f"{flops / lib / 1e9:.1f} TFLOP/s")
        r, kk, vv, w, u = wkv_inputs(ZOO_B * 64, ZOO_S, 64, dt, seed=8)
        y, sf = wk.wkv6_bh(r, kk, vv, w, u)
        # f32 ops, FMA = 2, per head and step: y_j = sum_i r_i S_ij (an
        # FMA a state element) + v_j * sum_i r_i u_i k_i (O(D): a product
        # and an FMA per i, an FMA per j), then S <- w S + k v^T (a
        # product and an FMA a state element): 5 D^2 + 5 D
        wflops = 5.0 * 64 * (64 + 1) * ZOO_S * ZOO_B * 64
        wb_ms, wby = bound_ms(nbytes(r, kk, vv, w, u, y, sf), wflops)
        wms = device_ms(lambda: wk.wkv6_bh(r, kk, vv, w, u), iters=10)
        wplain = device_ms(lambda: wr.wkv6_bh_ref(r, kk, vv, w, u), iters=1)
        out[tag]["wkv6_bh"] = {"ms": wms, "plain_ms": wplain,
                               "bound_ms": wb_ms, "bound_by": wby,
                               "library_ms": None}
        print(f"  wkv6_bh {tag} BH={ZOO_B * 64} S={ZOO_S} D=64: kernel "
              f"{wms * 1e3:9.2f} us  twin {wplain * 1e3:9.2f} us  bound "
              f"{wb_ms * 1e3:6.2f} us ({wby}, "
              f"{nbytes(r, kk, vv, w, u, y, sf) / 1e6:.1f} MB, "
              f"{wflops / 1e9:.1f} GFLOP)")
    print("  wkv6_bh has no library yardstick: no single PyTorch call runs "
          "the WKV recurrence")
    return out


def zoo_prefill(cfg, label: str, iters: int = 3):
    """The main path of the zoo: ``make_prefill_step`` on B x S prompts at
    full width, weights from the port's init (one generator seed).  Counts
    are set to 0 just before the first prefill and read just after it;
    returns (model, params, launches, ms per prefill)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.training.step import make_prefill_step
    model = build_model(cfg, DEVICE)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    n_params = model.param_count(params)
    tokens = torch.randint(0, cfg.vocab_size, (ZOO_B, ZOO_S),
                           generator=torch.Generator().manual_seed(1)
                           ).to(DEVICE)
    step = make_prefill_step(model)
    reset_all_launches()
    logits = step(params, {"tokens": tokens})
    sync()
    launches = all_launches()
    if tuple(logits.shape) != (ZOO_B, ZOO_S, cfg.vocab_padded) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{label}: prefill logits of shape "
                             f"{tuple(logits.shape)} are not all finite")
    del logits
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        step(params, {"tokens": tokens})
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    profile_step(lambda: step(params, {"tokens": tokens}),
                 f"{label} prefill")
    print(f"  {label} prefill: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({cfg.param_dtype}, compute "
          f"{cfg.dtype}), B={ZOO_B} x S={ZOO_S}: {ms:.1f} ms per prefill "
          f"(median of {iters}, first {times[0]:.1f}), "
          f"{ZOO_B * ZOO_S / ms * 1e3:.0f} prompt tokens/s; launches "
          f"{ {n: launches[n] for n in ZOO} }")
    return model, params, {n: launches[n] for n in ZOO}, ms


def profile_step(fn, label: str, top: int = 10):
    """One call of ``fn`` under torch.profiler: wall, device busy share,
    and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = _device_us(prof)
    if dev_us <= 0:
        print(f"  {label}: the profiler recorded no device time")
        return
    print(f"  {label} under the profiler: wall {wall * 1e3:.1f} ms, device "
          f"busy {dev_us / 1e3:.2f} ms -> busy share "
          f"{dev_us / 1e6 / wall:.3f}")
    print_top_kernels(prof, top)


def zoo_kernel_vs_cache(model, params, label: str, prompt: int = CACHE_PROMPT):
    """The reference's decode-matches-forward test at full width: the
    full-sequence forward through the kernel, its logits at the last
    position, against ``serving.decode.prefill`` walking the cache (or the
    RWKV state) token by token with no kernel; at the config's bf16 and
    at f32, from the same params."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.decode import prefill
    tokens = torch.randint(0, model.cfg.vocab_size, (1, prompt),
                           generator=torch.Generator().manual_seed(2)
                           ).to(DEVICE)
    for dtype in ("bfloat16", "float32"):
        m = build_model(model.cfg.replace(dtype=dtype), DEVICE)
        full, _ = m.forward(params, {"tokens": tokens})
        sync()
        t0 = time.perf_counter()
        last, _, _ = prefill(m, params, tokens, context_len=prompt)
        sync()
        loop_ms = (time.perf_counter() - t0) * 1e3
        a, b = full[:, -1].float(), last[:, 0].float()
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        if dtype == "float32":
            err, rel = rel_err(a, b)
            ok, what = rel <= ZOO_CACHE_F32_RTOL, (
                f"max abs {err:.3e}, rel {rel:.3e} (tol "
                f"{ZOO_CACHE_F32_RTOL:.0e})")
        else:
            frob = float((a - b).norm() / b.norm())
            ok, what = frob <= ZOO_CACHE_BF16_FROB, (
                f"relative Frobenius {frob:.3e} (tol {ZOO_CACHE_BF16_FROB})")
        print(f"  {label} {dtype}: kernel path vs cache path over a "
              f"{prompt}-token prompt: {what}, argmax agrees {agree:.2f}; "
              f"token loop {loop_ms:.0f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {dtype}: the kernel path and the "
                                 "cache path disagree")


def zoo_serving(rwkv_model, rwkv_params) -> dict:
    """``launch/serve.py`` on Llama-3.2-1B as a user runs it (greedy), and
    the same ``generate`` on the 4-layer RWKV6-7B; tokens per second."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import generate
    batch, plen, new = 4, 64, 32
    argv = ["--device", DEVICE, "--arch", "llama3.2-1b", "--batch",
            str(batch), "--prompt-len", str(plen), "--max-new", str(new)]
    sync()
    t0 = time.perf_counter()
    if serve.main(argv) != 0:
        raise AssertionError("launch/serve.py failed")
    sync()
    llama_s = time.perf_counter() - t0
    prompt = torch.randint(0, rwkv_model.cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(3)
                           ).to(DEVICE)
    reset_all_launches()
    sync()
    t0 = time.perf_counter()
    out = generate(rwkv_model, rwkv_params, prompt, max_new=new,
                   context_len=plen + new)
    sync()
    rwkv_s = time.perf_counter() - t0
    if tuple(out.shape) != (batch, new) or int(out.max()) >= \
            rwkv_model.cfg.vocab_padded or int(out.min()) < 0:
        raise AssertionError(f"rwkv6 generate gave {tuple(out.shape)} "
                             "tokens out of the vocab")
    rate = batch * new / rwkv_s
    print(f"  serve.main {' '.join(argv)}: {llama_s:.2f} s with init "
          f"(its own tok/s line above); rwkv6-7b ({RWKV_LAYERS} layers) "
          f"generate B={batch} prompt={plen} new={new}: {rwkv_s:.2f} s, "
          f"{rate:.1f} new tok/s (prompt fed token by token); launches "
          f"{ {n: all_launches()[n] for n in ZOO} } (decode runs no kernel)")
    return {"llama_serve_s": llama_s, "rwkv_generate_s": rwkv_s,
            "rwkv_tok_s": rate}


def zoo_card_vs_cpu():
    """The reduced configs (llama with 2 kv heads, rwkv6) at bf16 and f32:
    the card's kernel path against the CPU twins from one set of params,
    logits and greedy tokens (equal at f32)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import generate
    from repro_torch.utils.tree import tree_map
    for cfg in zoo_configs(reduced=True):
        for dtype in ("float32", "bfloat16"):
            c = cfg.replace(dtype=dtype)
            m_gpu, m_cpu = build_model(c, DEVICE), build_model(c, "cpu")
            p_cpu = m_cpu.init(torch.Generator().manual_seed(4))
            p_gpu = tree_map(lambda t: t.to(DEVICE), p_cpu)
            tokens = torch.randint(0, c.vocab_size, (2, 128),
                                   generator=torch.Generator().manual_seed(5))
            want, _ = m_cpu.forward(p_cpu, {"tokens": tokens})
            got, _ = m_gpu.forward(p_gpu, {"tokens": tokens.to(DEVICE)})
            got, want = got.float().cpu(), want.float()
            t_cpu = generate(m_cpu, p_cpu, tokens[:, :16], max_new=16,
                             context_len=32)
            t_gpu = generate(m_gpu, p_gpu, tokens[:, :16].to(DEVICE),
                             max_new=16, context_len=32).cpu()
            same = float((t_cpu == t_gpu).float().mean())
            if dtype == "float32":
                err, rel = rel_err(got, want)
                ok = rel <= ZOO_CPU_F32_RTOL and same == 1.0
                what = f"logits rel {rel:.3e} (tol {ZOO_CPU_F32_RTOL:.0e})"
            else:
                frob = float((got - want).norm() / want.norm())
                ok = frob <= ZOO_CPU_BF16_FROB
                what = (f"logits relative Frobenius {frob:.3e} (tol "
                        f"{ZOO_CPU_BF16_FROB})")
            must = " (must be 1)" if dtype == "float32" else ""
            print(f"  {c.name} reduced {dtype}: card vs CPU {what}; greedy "
                  f"tokens equal {same:.3f}{must} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{c.name} {dtype}: card and CPU "
                                     "disagree")


def zoo_path(chk: Check):
    """Phase 8; returns (kernel timing per dtype, launches of the main
    path: the two prefills)."""
    import torch
    t0 = time.perf_counter()
    check_zoo_kernels(chk)
    torch.cuda.synchronize()
    timing = time_zoo_kernels()
    llama_cfg, rwkv_cfg = zoo_configs()
    model, params, fa_launch, llama_ms = zoo_prefill(llama_cfg,
                                                     "llama3.2-1b")
    if fa_launch != {"flash_attention_bh": llama_cfg.num_layers,
                     "wkv6_bh": 0}:
        raise AssertionError(f"llama prefill launches {fa_launch}: expected "
                             f"one flash attention per layer")
    zoo_kernel_vs_cache(model, params, "llama3.2-1b")
    del model, params
    torch.cuda.empty_cache()
    r_model, r_params, wk_launch, rwkv_ms = zoo_prefill(
        rwkv_cfg, f"rwkv6-7b ({RWKV_LAYERS} of 32 layers)")
    if wk_launch != {"flash_attention_bh": 0,
                     "wkv6_bh": rwkv_cfg.num_layers}:
        raise AssertionError(f"rwkv6 prefill launches {wk_launch}: expected "
                             f"one wkv6 per layer")
    zoo_kernel_vs_cache(r_model, r_params, "rwkv6-7b")
    serving = zoo_serving(r_model, r_params)
    del r_model, r_params
    torch.cuda.empty_cache()
    zoo_card_vs_cpu()
    launches = {"flash_attention_bh": fa_launch["flash_attention_bh"],
                "wkv6_bh": wk_launch["wkv6_bh"]}
    print(f"  zoo phase wall time {time.perf_counter() - t0:.1f} s; prefill "
          f"llama3.2-1b {llama_ms:.1f} ms, rwkv6-7b ({RWKV_LAYERS} layers) "
          f"{rwkv_ms:.1f} ms; serving {serving}")
    return timing, launches


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
          f"(nvcc {_build.find_nvcc()}, one process per source); seconds "
          f"per library: "
          + ", ".join(f"{n} {sec:.1f}" for n, sec in built.items()))
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.is_file():
            for entry, regs, spill in ptxas_summary(log.read_text()):
                print(f"  ptxas {name}: {entry}: {regs} registers, {spill}")

    print("== phase 3: kernels vs plain twins on the card")
    chk = Check()
    check_case(chk, "main path", 10, 10, seed=0)
    check_case(chk, "main path", 10, 10, seed=0, bf16=True)
    check_case(chk, "odd cohort", 3, 7, seed=1)
    check_case(chk, "all-ones ties", 3, 2, seed=2, ones=True)
    check_case(chk, "all-ones ties", 3, 2, seed=2, ones=True, bf16=True)
    for bf16 in (False, True):
        check_single(chk, "one user", seed=3, bf16=bf16)
        check_single(chk, "one user, all-ones ties", seed=4, ones=True,
                     bf16=bf16)
    check_codec(chk)
    torch.cuda.synchronize()
    print(f"  bf16: smallest share of bitwise-equal elements per kernel "
          f"{chk.bf16_equal}; pool windows whose tie masks differ "
          f"{chk.tie_windows}")
    timing = time_kernels()
    timing.update(time_kernels(user=True))
    timing_bf16 = time_kernels(bf16=True)
    timing_bf16.update(time_kernels(bf16=True, user=True))
    timing.update(time_codec())
    print("  quantize_blocks has no library yardstick: no single PyTorch "
          "call does the row absmax, the scale, the rounding and the clip")

    print("== phase 4: fused path (paper config, every scheme, codec)")
    launches = main_path()
    share = device_busy_share()

    print("== phase 5: policy path (paper config, bf16, single-user, "
          "im2col)")
    user_launches, launches_bf16, policy_ms = policy_path()
    launches.update({n: user_launches[n] for n in USER_CNN})
    share_bf16 = device_busy_share(precision="bf16")

    print("== phase 6: serving path (paper config, codec, faults, crash)")
    codec_launches, serve_ms = serving_path()
    launches.update(codec_launches)
    serve_round_ms, serve_share = serving_busy_share()

    print("== phase 7: card vs CPU")
    card_vs_cpu()

    print("== phase 8: zoo path (Llama-3.2-1B, RWKV6-7B cut to "
          f"{RWKV_LAYERS} layers: prefill, cache path, serving)")
    zoo_timing, zoo_launches = zoo_path(chk)
    timing.update(zoo_timing["bf16"])
    launches.update(zoo_launches)

    rows = []
    for n in REPLACES:
        t = timing[n]
        row = {"name": n, "route": "cuda", "source": SOURCES[n],
               "replaces": REPLACES[n], "launches": launches[n],
               "max_abs_err": chk.err[n], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}
        if n in ZOO:
            tf = zoo_timing["f32"][n]
            row.update(dtype="bfloat16 (r/k/v; w f32)" if n == "wkv6_bh"
                       else "bfloat16", f32_ms=tf["ms"],
                       f32_plain_ms=tf["plain_ms"],
                       f32_bound_ms=tf["bound_ms"],
                       f32_library_ms=tf["library_ms"])
            row.update({key: val for key, val in t.items()
                        if key.startswith("d80_")})
            row.update({f"f32_{key}": val for key, val in tf.items()
                        if key.startswith("d80_")})
        if n in timing_bf16:
            tb = timing_bf16[n]
            row.update(bf16_launches=launches_bf16[n], bf16_ms=tb["ms"],
                       bf16_plain_ms=tb["plain_ms"],
                       bf16_bound_ms=tb["bound_ms"],
                       bf16_bitwise_share=chk.bf16_equal.get(n))
        rows.append(row)
    for r in rows:
        if not all(isinstance(r[key], (int, float)) and math.isfinite(r[key])
                   for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            raise AssertionError(f"non-finite number in {r}")
    print(f"device busy share (one fused opt round + eval): "
          f"{'not measured' if share is None else f'{share:.4f}'}; under "
          f"bf16: "
          f"{'not measured' if share_bf16 is None else f'{share_bf16:.4f}'}")
    print("policy rounds (opt b=2, paper config), median ms: "
          + ", ".join(f"{k} {v:.1f}" for k, v in policy_ms.items()))
    print(f"serving round (codec, paper config): {serve_round_ms:.1f} ms "
          f"wall, device busy share "
          f"{'not measured' if serve_share is None else f'{serve_share:.4f}'}"
          f"; launcher {serve_ms['b']:.1f} ms/round without faults")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
