"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. card: name and power limit from nvidia-smi, torch and CUDA versions.
   TF32 is switched off for matmuls and cuDNN, so every f32 product on the
   card (kernels and plain twins alike) runs in full f32;
2. build: the fused-CNN, delta-codec, flash-attention, WKV6 and moe
   dispatch kernels from the sources in this checkout, one nvcc each, in
   parallel (sm_90a);
   the seconds it took, and each kernel's registers and spills;
3. kernels vs their plain PyTorch twins on the card.  Blocked fused CNN:
   the main path's shapes (K=10 users, batch 10, both conv layers) at f32
   and bf16, a sweep group's folded cohort (K=60, B=10) at f32 and bf16,
   an odd cohort (K=3, B=7), the eval shape (K=1, B=1000), a sweep group's
   eval (K=6 models, B=1000, no residuals) and an all-ones pool-tie
   cohort.  Single-user fused CNN: one user of batch 10
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
   both attentions' TFLOP/s; the moe dispatch kernels (slots, scatter,
   combine) against the plain scatter path at granite-prefill-chat's
   batch (T 18432, top-8 of 40 experts, d 1536, skewed routes that drop)
   and a small ragged shape at k = 1, f32 and bf16 (slots, keep and
   buffer bit for bit, the combine bit for bit to its twin), each timed
   at the cell's shape beside its byte bound and the plain version;
   (b) ``make_prefill_step`` on Llama-3.2-1B as
   configured and on RWKV6-7B at full width with 4 of its 32 layers, B=2
   x 2048-token prompts, counts reset just before: one kernel launch per
   layer; (c) the kernel path against the cache path (the token loop of
   ``serving.decode.prefill``) over a 256-token prompt at bf16 and f32;
   (d) ``launch/serve.py`` on Llama-3.2-1B and ``generate`` on the 4-layer
   RWKV6-7B, tokens per second; (e) card vs CPU at the reduced size:
   logits, and greedy tokens equal at f32.  Then the moe, hybrid, vlm and
   audio families, each at full width and depth (granite-moe-3b-a800m,
   hymba-1.5b, qwen2-vl-2b, hubert-xlarge), one loaded at a time: (a)
   flash attention against its twin at their shapes (groups of 3, 5 and 6;
   hymba's odd B·H) with the other 8a cases; (b) the prefill at B=2 x
   2048 (hubert: 1500 frames) from ``models.inputs.materialize``, counts
   set to 0 just before: one flash launch per layer and, on granite, one
   call of each moe dispatch wrapper per layer; ms, prompt tokens/s,
   busy share and top device ops, granite's scatter-dropped share and
   dense-dispatch ms, hymba's mamba-loop share; (c) the kernel path
   against the cache path at 256 text tokens (granite under the dense
   dispatch); (d) ``generate`` (B=4, prompt 64, 32 new, greedy) for the
   decoders, and ``launch/serve.py`` on hymba-1.5b; (e) card vs CPU at the
   reduced sizes: f32 1e-4, bf16 3% Frobenius, greedy tokens equal at
   f32;
9. the sweep path (``Experiment(...).run(engine="sweep")``) at the paper's
   configuration with the rounds cut to 5: (a) a Fig. 3(b) panel (opt
   b=2, async b=1, discard b=1, seeds 0 and 1: 2 programs), (b) the Fig.
   3(c) budget axis (b = 1..6, one seed: 6 configs folded into a cohort of
   60 users), (c) the codec panel (opt and discard with the codec: 1
   program).  Each panel runs with every count set to 0 just before and
   read just after; each group's training kernels must launch rounds x e x
   steps x (their launches per step) times whatever its number of
   (simulation, config) rows, the eval once per layer per round, the codec
   one quantize per epoch and one dequantize per round.  For every group:
   the round loop runs again under ``torch.cuda.set_sync_debug_mode
   ("error")`` (no host round trip), a second run is equal bit for bit, the
   row of seed 1 equals seed 1 run alone, and 2 rounds on the card equal 2
   on the CPU from one CPU-drawn stream (counts, params within
   ``PARAM_ATOL``, plus one quantization step with the codec).  It prints
   each group's ms per simulated round per (simulation, config) beside
   phase 4's fused round, the device busy share of one group round under
   the profiler, and the final test accuracy;
10. zoo training (TF32 off).  (a) ``make_train_step`` on Llama-3.2-1B as
   configured (16 layers, d 2048, vocab 128 256, tied; bf16 compute on f32
   params) with AdamW + cosine and a clip of 1.0, B=2 x S=2048 from
   ``make_token_stream`` (S > 1024: ``_sdpa_chunked``), counts set to 0
   just before: one warm-up and 4 timed steps on one batch, ms per step,
   training tokens/s, peak memory, the busy share of one step under the
   profiler; the loss finite and falling, every param leaf moved, no
   flash or WKV6 launch, and a no_grad prefill after it one flash launch
   a layer; (b) loss and grads at the same params under remat "full" and
   "dots" (bitwise expected, 1e-6 of the largest) and the fused head (loss
   within 1e-5), with each one's peak memory; (c) 2 steps, a checkpoint, a
   restore into a fresh state and 2 more against 4 steps (reduced, bit
   for bit), and ``launch/train.py`` on the card resumed from its step-10
   checkpoint against the uninterrupted run (byte for byte); (d) every
   family of ``ARCH_IDS`` reduced at f32: one AdamW step on the card
   against the CPU (loss 1e-5, params 1e-4 of the largest); (e) the
   three example twins as subprocesses (``uav_fl_sim --rounds 2``).  No
   zoo or moe dispatch kernel may launch in any training step of the
   phase;
11. ranks on the card (``launch.mesh.spawn_ranks``; ranks that share the
   card use gloo, the backend named in every line).  (a) OpportunisticSync
   (``core.opportunistic_sync.make_opp_sync_round``) with 4 pods, one rank
   each, on Llama-3.2-1B at full width with 4 of its 16 layers (four
   pods' f32 state fits one card only cut in depth), bf16 compute on f32
   params, TF32 off, sgd(1e-2), B=2 x S=512 per inner step from
   ``make_token_stream``, e=6, b=2, outage 0.3: 3 rounds of opt, 1 of
   async, 1 of discard from one ``channel_trace`` seed; after every round
   each rank's params are bitwise rank 0's, the snapshot slots are reset,
   and each pod's snapshot decisions equal the host's recomputation from
   the trace (eq. 15 τ against the allowance, the schedule, the outage);
   losses finite; no zoo kernel launch on any rank.  It prints ms per
   round per rank, ``round_sync`` alone, each rank's peak memory and the
   backend.  (b) The same rounds at the reduced size at f32 on the card
   and on 4 CPU ranks: decisions and arrivals equal, loss within 1e-5,
   params within 1e-4 of the largest.  (c) Phase 9's Fig. 3(b) panel over
   2 ranks (one seed each) through ``Experiment.run(mesh=...)``: each
   rank's launches equal the panel's, every gathered row (counts, bytes,
   test loss and accuracy, final params) bitwise phase 9's.  (d) The
   multipod twin (``repro_torch.examples.opportunistic_multipod --rounds
   2``) as a subprocess;
12. the dry run (``repro_torch.launch.dryrun``).  (a) ``run_one`` for
   Llama-3.2-1B x train_4k, prefill_32k and decode_32k, with calibration,
   on the 16 x 16 and 2 x 16 x 16 meshes of fake 256- and 512-rank worlds
   (fake CUDA tensors, each program in a spawned process, six at once):
   its seconds, bytes per device against the card's memory, the three
   roofline terms at the H100 datasheet's rates, the dominant one and the
   useful ratio; the calibrated FLOPs must equal the full program's, and
   no process may allocate card memory; hubert-xlarge x long_500k is a
   documented skip.  (b) Phase 10's Llama-3.2-1B step (B=2 x 2048, AdamW,
   clip 1.0, remat none) predicted on a fake one-rank world's (1, 1)
   mesh, then run once on the card under the same counter: FLOPs equal,
   the predicted peak within 0.8-1.25x of ``max_memory_allocated`` (less
   what the card held before beyond the step's arguments); the step's ms
   against the roofline's largest term;
13. the analysis on the card (``repro_torch.analysis``).  (a) ``python -m
   repro_torch.analysis --strict-baseline`` as a subprocess with no
   ``--device``: the lint clean and the contracts on the card (the rounds
   at their tiny sizes and the twins' kernel sides launch for real); and
   ``--ir``, started as a subprocess with phase 12 on the cores its dry
   run leaves: the IR sweep clean (every registry program traced on the
   CPU through the twins at K = 4, 16, 64, 256: the graph walk, the bf16
   audit and the K-scaling gate against
   ``src/repro_torch/analysis/scaling.json``); (b) phase 9's Fig. 3(c) group and its codec groups, each round
   loop under ``engine_guard(budget=<its expected launches>)`` and the
   device-to-host guard: launches equal to the budget, no implicit
   transfer either way, no ``torch.func`` leak, no library build; (c)
   every guard bites: a round output's ``.item()`` under
   ``no_implicit_transfers("all")``, ``torch.ones(4).cuda()`` under
   ``engine_guard()``, one launch over a round's budget, and the fused
   opt round at the paper's configuration under ``memory_budget`` at half
   its peak (and passes at its peak plus ``PEAK_SLACK``); (d) the IR
   walker's peak of that same round, traced on the CPU from the card
   run's own inputs, beside the card's ``max_memory_allocated`` for it,
   and their ratio (no bound).  It prints its wall time;
14. the card's line, the moe dispatch kernels' JSON line (8a's times,
   bounds, largest gaps and dropped shares), the kernels' JSON line (the
   zoo and moe rows with ``train_launches``, phase 10's count, and
   ``opp_sync_launches``, phase 11's, both 0; the moe rows, which replace
   no TPU kernel, also with ``family_launches``, each family prefill's
   wrapper calls, ``launches_per_call``, the ``__global__`` launches a
   call, and ``sweep_launches``; the fused-CNN and moe rows with
   ``sharded_sweep_launches``, each sweep rank's count), every phase's
   wall time and the script's total, and the result line.

Every phase prints its wall time when it ends.  Cut in depth or
repetition to keep the script within half its 1200 s limit: 8c's
kernel-vs-cache loops run the first ``CACHE_LAYERS`` layers of each model
at full width (granite's bf16 loop at full depth), hymba-1.5b's prefill is timed once
and its launcher run feeds 16 prompt and 8 new tokens, and phase 11 runs
one round per scheme.

It imports nothing of JAX.  Without a CUDA card it exits 2 and prints no
result.
"""
from __future__ import annotations

import copy
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

# profiler sessions tried before a timing falls back to CUDA events
PROFILE_TRIES = 3

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
# the moe dispatch kernels replace no TPU kernel (the reference does this
# in jnp), so they have no REPLACES entry
MOE = ("moe_slots", "moe_scatter", "moe_combine")
KERNELS = tuple(REPLACES) + MOE
SOURCES = {**{n: "src/repro_torch/kernels/fused_cnn/csrc/fused_cnn.cu"
              for n in FUSED_CNN + USER_CNN},
           **{n: "src/repro_torch/kernels/delta_codec/csrc/delta_codec.cu"
              for n in CODEC},
           "flash_attention_bh":
               "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
           "wkv6_bh": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
           **{n: "src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu"
              for n in MOE}}
# scratch for the serving phase's checkpoints (git-ignored)
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
# __global__ launches per wrapper call (a kernel's ``LAUNCHES`` counts its
# wrapper's calls)
LAUNCHES_PER_CALL = {"conv_pool_fwd_k": 1, "conv_pool_bwd_k": 1,
                     "fc_chain_fwd_k": 1, "fc_chain_bwd_k": 1,
                     "conv_pool_fwd": 1, "conv_pool_bwd": 1,
                     "fc_chain_fwd": 1, "fc_chain_bwd": 1,
                     "moe_slots": 3, "moe_scatter": 1, "moe_combine": 1}


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
    return float(ev.self_device_time_total)


class DeviceEvent:
    """One kernel's (or copy's) device records in a profile, summed."""

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def _device_events(prof) -> list:
    """A profile's events on the device (kernels, copies), summed by name
    from the profiler's raw records (``kineto_results``).  Its
    ``key_averages`` would build a Python event for every record, device
    and host: for hymba's prefill (~130 000 launches) that took about 100
    s on the H100 machine's host, for the same sums.  The host ops are
    left out (``aten::mm`` carries the device time of the kernels it
    launched as its own, so counting it too would count those kernels
    twice), and so is the profiler's own buffer bookkeeping."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_hidden_event():
            continue
        name = ev.name()
        if name.startswith("Activity Buffer"):
            continue
        agg = out.setdefault(name, DeviceEvent(name))
        agg.count += 1
        agg.self_device_time_total += ev.duration_ns() / 1e3
    return list(out.values())


def _device_us(events) -> float:
    """Summed device time (us) of a profile's kernels and copies (its
    ``_device_events``)."""
    return sum(_self_device_us(ev) for ev in events)


def print_top_kernels(events, top: int) -> None:
    for ev in sorted(events, key=_self_device_us, reverse=True)[:top]:
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
    ``iters / 2`` records of it are lost).

    Now and then a whole session records no device event (once in phase
    3, on the H100).  The session is then run again, up to PROFILE_TRIES
    times in all; after that the calls are timed back to back with CUDA
    events (launch gaps included), and the line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
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
                split[ev.key] = (_self_device_us(ev) / ev.count * per_call
                                 / 1e3)
        if sum(split.values()) > 0:
            break
        print("    (the profiler recorded no device time in this session)")
    else:
        ms = cuda_ms(fn, iters)
        print(f"    (no device time in {PROFILE_TRIES} profiler sessions: "
              f"timed with CUDA events over back-to-back calls, {ms:.4f} "
              f"ms a call)")
        return {"CUDA events, back to back": ms}
    if lost > 0:
        print(f"    (the profiler lost {lost} kernel records of {iters} "
              f"calls; timed from the records it kept)")
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


def check_eval_group(chk: Check, g: int = 6, seed: int = 7):
    """A sweep group's eval: G models each on the 1000 test images, the
    forward kernels at K = G without residuals, against the twins."""
    from repro_torch.kernels.fused_cnn import kernel as knl, ref
    params, x, _ = make_case(g, 1000, seed, DEVICE)
    print(f" case sweep eval: K={g} B=1000 f32, no residuals")
    a_in = x
    for layer in ("conv1", "conv2"):
        w, b = params[layer]["w"], params[layer]["b"]
        ak, none = knl.conv_pool_fwd_k(a_in, w, b, residuals=False)
        ap, _ = ref.conv_pool_fwd_k(a_in, w, b, residuals=False)
        if none is not None:
            raise AssertionError("the eval forward wrote residuals")
        chk.close("conv_pool_fwd_k", f"eval {layer} a (K={g},B=1000)", ak,
                  ap, exact=True)
        a_in = ap
    lk, _ = knl.fc_chain_fwd_k(a_in.reshape(g, 1000, -1), params)
    lp, _ = ref.fc_chain_fwd_k(a_in.reshape(g, 1000, -1), params)
    chk.close("fc_chain_fwd_k", f"eval logits (K={g},B=1000)", lk, lp)


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
    # (a single row stays Gaussian)
    zeros = [r for r in range(7 if m == 1 else 0, m, 7)
             if r not in set(ties)]
    x[zeros] = 0.0
    for r in ties:
        sc = 2.0 ** -(8 + r % 5)
        k = torch.randint(-qmax, qmax, (block - 1,), generator=g).float()
        x[r, 0] = qmax * sc
        x[r, 1:] = (k + 0.5) * sc
    return x.to(DEVICE), zeros, ties


def check_codec(chk: Check):
    """Both codec kernels vs their twins on the card, bitwise, over the
    shapes the paths use (the fused round's 2560 rows, one tree's 217,
    blocks of 512 and 128) and the quantize kernel's other paths (one row;
    1024, the widest row a warp holds in registers; 2048, which loops over
    pieces); the tie rows must round half to even."""
    import torch
    from repro_torch.kernels.delta_codec import kernel as knl, ref
    for m, blocks in ((2560, (512, 128, 1024)), (217, (512, 128, 2048)),
                      (1, (512, 2048))):
        for block in blocks:
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
              f"bound {b_ms * 1e3:6.2f} us ({by}, {nbytes / 1e6:.2f} MB; "
              f"the kernel at {b_ms / ms:.1%} of it)  back-to-back wall "
              f"{wall * 1e3:8.2f} us")
    # one tree (the host engine's and the server's snapshots)
    x1 = torch.randn((217, block), device=DEVICE) * 1e-3
    q1, s1 = ref.quantize_ref(x1, bits)
    b1_ms, _ = bound_ms(4 * numel(x1) + numel(q1) + 4 * numel(s1), 0.0)
    q1_ms = device_ms(lambda: knl.quantize_blocks(x1, bits=bits), 200)
    print(f"  one tree (217 rows): quantize {q1_ms * 1e3:.2f} us (bound "
          f"{b1_ms * 1e3:.2f} us, {b1_ms / q1_ms:.1%} of it), dequantize "
          f"{device_ms(lambda: knl.dequantize_blocks(q1, s1), 200) * 1e3:.2f}"
          f" us")
    out["quantize_blocks"]["tree_ms"] = q1_ms
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
    from repro_torch.kernels.moe_dispatch import kernel as mk
    from repro_torch.kernels.wkv6 import kernel as wk
    for mod in (fk, dk, fa, wk, mk):
        mod.reset_launches()


def bf16_launches() -> dict:
    from repro_torch.kernels.fused_cnn import kernel as fk
    return dict(fk.LAUNCHES_BF16)


def all_launches() -> dict:
    from repro_torch.kernels.delta_codec import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_cnn import kernel as fk
    from repro_torch.kernels.moe_dispatch import kernel as mk
    from repro_torch.kernels.wkv6 import kernel as wk
    return {**fk.LAUNCHES, **dk.LAUNCHES, **fa.LAUNCHES, **wk.LAUNCHES,
            **mk.LAUNCHES}


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
    want = dict.fromkeys(KERNELS, 0)
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
        if scheme == "opt" and not codec:
            opt_ms = float(np.median(times[1:]))
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
    return got, opt_ms


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
    events = _device_events(prof)
    dev_us = _device_us(events)
    if dev_us <= 0:
        print("  profiler: no device time recorded (busy share not measured)")
        return None
    share = dev_us / 1e6 / wall
    print(f"  profiler: one opt round + eval {kw or ''}: wall "
          f"{wall * 1e3:.1f} ms, "
          f"device busy {dev_us / 1e3:.2f} ms -> busy share {share:.3f}, "
          f"idle share {1 - share:.3f}")
    print_top_kernels(events, 12)
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
    events = _device_events(prof)
    dev_us = _device_us(events)
    if dev_us <= 0:
        print("  profiler: no device time recorded (busy share not measured)")
        return wall_plain * 1e3, None
    share = dev_us / 1e6 / wall
    print(f"  server round 2: wall {wall_plain * 1e3:.1f} ms; round 3 under "
          f"the profiler: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms -> busy share {share:.3f}, idle share "
          f"{1 - share:.3f}")
    print_top_kernels(events, 10)
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
# phase 9: the sweep path (the device round, the sweep engine, the facade)
# ---------------------------------------------------------------------------

SWEEP_ROUNDS = 5
SWEEP_CPU_ROUNDS = 2        # card vs CPU: the CPU runs G·K users per step


def sweep_panels():
    """The three panels at the paper's config, rounds cut to 5, with the
    round programs each must need."""
    from dataclasses import replace
    from repro_torch.api import Experiment
    from repro_torch.core.hsfl import HSFLConfig
    from repro_torch.core.sweep import fig3c_spec
    cfg = HSFLConfig(rounds=SWEEP_ROUNDS)
    return [
        ("fig3b", Experiment(cfg).with_scheme("opt", b=2.0)
         .with_scheme("async", b=1.0).with_scheme("discard", b=1.0)
         .with_seeds(0, 1), 2),
        ("fig3c", Experiment.from_spec(fig3c_spec(rounds=SWEEP_ROUNDS)[0]),
         1),
        ("codec", Experiment(replace(cfg, use_delta_codec=True))
         .with_scheme("opt", b=2.0).with_scheme("discard", b=1.0), 1)]


def expected_sweep_launches(groups, rounds: int) -> dict:
    """Launches a panel's groups need, whatever their (simulation, config)
    rows: per round e·S training steps (2 conv fwd, 2 conv bwd, 1 fc fwd,
    1 fc bwd launches each) and one eval (2 conv fwd + 1 fc fwd); with the
    codec on a probing program one quantize per epoch and one dequantize
    per round."""
    from repro_torch.core.schemes import get_scheme
    out = dict.fromkeys(KERNELS, 0)
    for g in groups:
        steps = rounds * g.base.local_epochs * g.base.steps_per_epoch
        out["conv_pool_fwd_k"] += 2 * steps + 2 * rounds
        out["conv_pool_bwd_k"] += 2 * steps
        out["fc_chain_fwd_k"] += steps + rounds
        out["fc_chain_bwd_k"] += steps
        prog = get_scheme(g.program_scheme or g.scheme)
        if g.base.use_delta_codec and prog.uses_probes:
            out["quantize_blocks"] += rounds * g.base.local_epochs
            out["dequantize_blocks"] += rounds
    return out


def run_group(group, device, rounds: int, stream_factory=None,
              sync_check: bool = False):
    """One group through the engine's pieces: (metrics, final params (G,
    ...), ms of the round loop).  ``sync_check`` runs the loop under
    ``torch.cuda.set_sync_debug_mode("error")``: any host round trip in
    it raises."""
    import torch
    from repro_torch.core import sweep
    data = sweep._sim_tensors(sweep._stack_sims(group), device)
    kw = {} if stream_factory is None else {"stream_factory": stream_factory}
    carry, streams, cfg = sweep._group_inputs(group, data, device, **kw)
    fn = sweep.build_device_round(**sweep._group_build_kwargs(group))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        carry, per_round = sweep._scan_rounds(fn, carry, streams, data, cfg,
                                              rounds)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
    metrics = sweep._read_metrics(per_round, len(group.sims),
                                  len(group.cfgs))
    ms = (time.perf_counter() - t0) * 1e3
    return metrics, carry.params, ms


def sweep_busy_share(group):
    """Wall time and device busy share of one steady round of a group
    (after a first round), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import sweep
    data = sweep._sim_tensors(sweep._stack_sims(group), DEVICE)
    carry, streams, cfg = sweep._group_inputs(group, data, DEVICE)
    fn = sweep.build_device_round(**sweep._group_build_kwargs(group))
    carry, _ = fn(carry, 1, streams, data, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(carry, 2, streams, data, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    dev_us = _device_us(events)
    share = dev_us / 1e6 / wall if dev_us > 0 else None
    return wall * 1e3, dev_us / 1e3, share, events


def _same_tree(a, b) -> bool:
    import torch
    from repro_torch.utils.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def check_group(group, fused_ms: float) -> dict:
    """The per-group checks of the sweep phase (see the module's
    docstring, phase 9); returns the group's numbers."""
    from dataclasses import replace
    from repro_torch.core.streams import TorchStream
    from repro_torch.utils.tree import tree_leaves
    label = f"{group.label}[S={len(group.sims)},C={len(group.cfgs)}]"
    reset_all_launches()
    m1, p1, ms = run_group(group, DEVICE, SWEEP_ROUNDS, sync_check=True)
    want = expected_sweep_launches([group], SWEEP_ROUNDS)
    if all_launches() != want:
        raise AssertionError(f"sweep {label}: launches {all_launches()} != "
                             f"expected {want}")
    m2, p2, _ = run_group(group, DEVICE, SWEEP_ROUNDS)
    if not all(np.array_equal(m1[k], m2[k]) for k in m1) or \
            not _same_tree(p1, p2):
        raise AssertionError(f"sweep {label}: two runs differ")
    # the row of seed 1 against seed 1 alone
    dist = group.sims[0][1]
    pair = replace(group, sims=((0, dist), (1, dist)))
    alone = replace(group, sims=((1, dist),))
    mp, pp, _ = run_group(pair, DEVICE, SWEEP_ROUNDS)
    ma, pa, _ = run_group(alone, DEVICE, SWEEP_ROUNDS)
    c = len(group.cfgs)
    if not all(np.array_equal(mp[k][1], ma[k][0]) for k in mp) or \
            not all(__import__("torch").equal(x[c:], y) for x, y in zip(
                tree_leaves(pp), tree_leaves(pa))):
        raise AssertionError(f"sweep {label}: the row of seed 1 differs "
                             "from seed 1 run alone")
    # card vs CPU from one CPU-drawn stream
    short = replace(group, base=replace(group.base,
                                        rounds=SWEEP_CPU_ROUNDS))
    drawn = lambda cfg, dev: TorchStream(cfg.seed, dev, draw_on="cpu")  # noqa
    with ScaleSpy() as spy:
        mg, pg, _ = run_group(short, DEVICE, SWEEP_CPU_ROUNDS, drawn)
        mc, pc, _ = run_group(short, "cpu", SWEEP_CPU_ROUNDS, drawn)
    counts = ("selected", "arrived", "rescued", "delayed", "dropped")
    if not all(np.array_equal(mg[k], mc[k]) for k in counts):
        raise AssertionError(
            f"sweep {label}: card and CPU counts differ: "
            f"{ {k: (mg[k].tolist(), mc[k].tolist()) for k in counts} }")
    diff = max(float((x.cpu().double() - y.double()).abs().max())
               for x, y in zip(tree_leaves(pg), tree_leaves(pc)))
    tol = PARAM_ATOL + (spy.max if group.base.use_delta_codec else 0.0)
    dacc = float(np.abs(mg["test_acc"] - mc["test_acc"]).max())
    if not diff <= tol or not dacc <= 1.0 / group.base.n_test + 1e-9:
        raise AssertionError(f"sweep {label}: card vs CPU params differ by "
                             f"{diff} (tol {tol}), accuracy by {dacc}")
    rows = len(group.sims) * c
    per_row = ms / SWEEP_ROUNDS / rows
    wall, dev_ms, share, events = sweep_busy_share(group)
    acc = m1["test_acc"][..., -1]
    print(f"  {label}: {ms / SWEEP_ROUNDS:.1f} ms a round, {per_row:.2f} "
          f"ms per simulated round per (sim, config) (phase 4 fused opt "
          f"round {fused_ms:.1f}); launches as expected "
          f"{ {n: c for n, c in want.items() if c} }; no host round trip "
          f"in the loop; two "
          f"runs equal; seed 1's row equals seed 1 alone; card vs CPU "
          f"({SWEEP_CPU_ROUNDS} rounds) counts equal, params within "
          f"{diff:.2e} (tol {tol:.2e}); one round under the profiler "
          f"{wall:.1f} ms wall, {dev_ms:.2f} ms device, busy share "
          f"{'not measured' if share is None else f'{share:.3f}'}; final "
          f"test accuracy {acc.round(4).tolist()}")
    print_top_kernels(events, 6)
    return {"round_ms": ms / SWEEP_ROUNDS, "per_row_ms": per_row,
            "busy": share, "rows": rows, "acc": acc}


def sweep_path(fused_ms: float):
    """Phase 9; returns the launches over the three panels, each group's
    numbers and each panel's ``SweepResult``."""
    from repro_torch.core.sweep import compile_spec
    total = dict.fromkeys(KERNELS, 0)
    numbers, results = {}, {}
    for name, ex, n_prog in sweep_panels():
        groups = compile_spec(ex.to_spec())
        reset_all_launches()
        sync()
        t0 = time.perf_counter()
        res = ex.run(engine="sweep")          # the card: no device argument
        results[name] = res
        sync()
        wall = time.perf_counter() - t0
        got = all_launches()
        want = expected_sweep_launches(groups, SWEEP_ROUNDS)
        print(f"  panel {name}: {len(res.groups)} groups, {res.n_programs} "
              f"programs (program ids {[g.program_id for g in res.groups]}),"
              f" {res.n_simulations} (sim, config) rows, {wall:.2f} s; "
              f"launches {got}")
        if res.n_programs != n_prog:
            raise AssertionError(f"panel {name}: {res.n_programs} programs, "
                                 f"not {n_prog}")
        if got != want:
            raise AssertionError(f"panel {name}: launches {got} != "
                                 f"expected {want}")
        for g in res.groups:
            m = g.metrics
            if not (np.all(np.isfinite(m["test_loss"]))
                    and m["test_acc"].shape == (len(g.sims), len(g.cfgs),
                                                SWEEP_ROUNDS)
                    and np.all(m["arrived"] + m["dropped"] + m["delayed"]
                               + m["rescued"] <= m["selected"])):
                raise AssertionError(f"panel {name}: bad metrics in "
                                     f"{g.label}")
        # 5 rounds of lr 0.01 on non-iid clients sit near chance (the fused
        # opt round: 0.129); the panel's best row must be above it
        best = max(float(g.metrics["test_acc"][..., -1].max())
                   for g in res.groups)
        if not best > 0.1:
            raise AssertionError(f"panel {name}: best final accuracy {best} "
                                 "is not above chance (0.1)")
        for n in total:
            total[n] += got[n]
        for group in groups:
            numbers[f"{name}/{group.label}"] = check_group(group, fused_ms)
    path = FUSED_CNN + CODEC
    if min(total[n] for n in path) <= 0:
        raise AssertionError("a kernel of the sweep path never launched")
    return total, numbers, results


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
# the kernel-vs-cache check (8c) runs the first CACHE_LAYERS layers of each
# model at full width: its token loop is host-bound and linear in depth.
# Not the moe at bf16: that check measures routes that move with depth (cut
# to 4 of 32 layers granite moved 17.6% of them and missed the 5% bound on
# the H100), so granite keeps its full depth there; at f32 its routes do
# not move (0 of 256 at full depth), and it takes the cut
CACHE_LAYERS = 4
# hymba-1.5b's prefill (~2-4 s, the mamba loop) is timed once: its median
# of 3 equalled its first
HYMBA_PREFILL_ITERS = 1
# the moe, hybrid and vlm families' attention (q heads, kv heads, D)
FAMILY_HEADS = {"granite-moe-3b-a800m": (24, 8, 64),
                "hymba-1.5b": (25, 5, 64),
                "qwen2-vl-2b": (12, 2, 128)}
# the four families of phase 8's second part, each at full width and depth
FAMILIES = ("granite-moe-3b-a800m", "hymba-1.5b", "qwen2-vl-2b",
            "hubert-xlarge")
# reduced variants for card vs CPU that keep GQA with 2 kv heads
REDUCED_KV = {"llama3.2-1b": 2, "granite-moe-3b-a800m": 2, "hymba-1.5b": 2}
# moe card vs CPU at bf16: the share of tokens whose route may move (a
# router probability within bf16 roundings of the k-th one; 10% leaves
# room over the share measured, see PERF.md)
MOE_MOVED_MAX = 0.10


def zoo_configs():
    """Llama-3.2-1B, and RWKV6-7B cut to RWKV_LAYERS layers."""
    from repro_torch.configs import get_config
    return (get_config("llama3.2-1b"),
            get_config("rwkv6-7b").replace(num_layers=RWKV_LAYERS))


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
              (ZOO_B, 16, 16, HUBERT_S, HUBERT_S, 80, False, 0, f32)),
             # the f32 kernel's widest instantiation (acc 4 x 16 a lane)
             ("D=128 causal f32", (ZOO_B, 8, 2, 1024, 1024, 128, True, 0,
                                   f32))]
    # the other families' attention at their prefill shapes: the groups
    # of 3 (granite), 5 (hymba: 25 q heads, so B·H is odd at B = 1 and 3)
    # and 6 (qwen2-vl, D=128)
    for fam, (h, kv, d) in FAMILY_HEADS.items():
        for dt, tag in ((bf, "bf16"), (f32, "f32")):
            cases.append((f"{fam} G={h // kv} D={d} {tag}",
                          (ZOO_B, h, kv, s, s, d, True, 0, dt)))
    for b, sl in ((1, s), (3, 300)):
        for dt, tag in ((bf, "bf16"), (f32, "f32")):
            cases.append((f"hymba-1.5b B·H={b * 25} S={sl} {tag}",
                          (b, 25, 5, sl, sl, 64, True, 0, dt)))
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
          f"{flops / ms / 1e9:.1f} TFLOP/s ({b_ms / ms:.1%} of the bound, "
          f"{ms / lib:.3f}x SDPA's time), SDPA {flops / lib / 1e9:.1f} "
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
              f"{flops / ms / 1e9:.1f} TFLOP/s ({b_ms / ms:.1%} of the "
              f"bound, {ms / lib:.3f}x SDPA's time), SDPA "
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


# the moe dispatch kernels' shapes (T, k, E, d, skew): granite-prefill-
# chat's batch (18432 tokens, top-8 of 40 experts, d 1536; routes drawn
# with weights exp(skew·e), so the high experts overflow as the cell's do)
# and a small ragged one at k = 1
MOE_CELL = (18432, 8, 40, 1536, 0.05)
MOE_SMALL = (333, 1, 16, 64, 0.3)


def moe_case(shape, dtype, seed: int = 0):
    """x (T, d), flat_e (T·k,) with k distinct experts a token, flat_w
    (T·k,) and the capacity C, on the card."""
    import torch
    from repro_torch.models import moe
    T, k, E, d, skew = shape
    g = torch.Generator().manual_seed(seed)
    w = torch.exp(skew * torch.arange(E, dtype=torch.float64))
    flat_e = torch.multinomial(w.expand(T, E), k, replacement=False,
                               generator=g).reshape(T * k)
    x = torch.randn(T, d, generator=g).to(dtype)
    flat_w = torch.rand(T * k, generator=g).to(dtype)
    C = max(8, int(moe.CAPACITY_FACTOR * T * k / E + 0.5))
    return x.to(DEVICE), flat_e.to(DEVICE), flat_w.to(DEVICE), C


def moe_plain_dispatch(x, flat_e, E, C, k):
    """The plain path's slots and buffer (``moe._dispatch`` after its
    router, ``ref.slots_ref`` and ``ref.scatter_ref``): the one-hot
    cumsum, each token repeated k times, a zeroed (E·C + 1, d) buffer and
    ``index_copy_``."""
    from repro_torch.kernels.moe_dispatch import ref as mr
    slot, keep, counts = mr.slots_ref(flat_e, E, C)
    return mr.scatter_ref(x, slot, E, C, k), slot, keep, counts


def check_moe_dispatch() -> tuple:
    """The moe dispatch kernels against the plain path at the cell's shape
    and the small one, f32 and bf16: slots, keep and buffer bit for bit,
    the combine bit for bit to its twin and within the f32 sums'
    reordering (2**-20 of the products' magnitudes) plus, at bf16, one
    bf16 ulp (2**-7 of the output) of the plain ``_combine``.  Returns the
    dropped share of each case and each kernel's largest gap to its plain
    code over the cases (0: asserted bitwise)."""
    import torch
    from repro_torch.kernels.moe_dispatch import kernel as mk, ref as mr
    from repro_torch.models import moe
    out, err = {}, dict.fromkeys(MOE, 0.0)
    for label, shape in (("cell", MOE_CELL), ("small", MOE_SMALL)):
        T, k, E, d, _ = shape
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, flat_e, flat_w, C = moe_case(shape, dt)
            want, want_slot, want_keep, want_counts = moe_plain_dispatch(
                x, flat_e, E, C, k)
            slot, keep, counts = mk.moe_slots(flat_e, E, C)
            buf = mk.moe_scatter(x, slot, counts, E, C, k)
            eo = torch.randn(E, C, d, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(5)
                             ).to(dt)
            y = mk.moe_combine(eo, slot, flat_w, k)
            plain = moe._combine(eo, want_slot, want_keep, flat_w, T, 1,
                                 k).reshape(T, d)
            sync()
            rows = torch.cat([eo.reshape(E * C, d),
                              torch.zeros(1, d, dtype=dt, device=DEVICE)])
            prods = (rows[want_slot].float() * flat_w.float()[:, None]).abs()
            room = 2 ** -20 * prods.reshape(T, k, d).sum(1)
            if dt == torch.bfloat16:
                room = room + 2 ** -7 * plain.float().abs()
            gap = (y.float() - plain.float()).abs()
            twin = mr.combine_ref(eo, slot, flat_w, k)
            ok = {"slot": torch.equal(slot, want_slot),
                  "keep": torch.equal(keep, want_keep),
                  "counts": torch.equal(counts, want_counts)
                  and torch.equal(counts.long(), torch.bincount(
                      flat_e, minlength=E)),
                  "buffer": torch.equal(buf, want),
                  "combine_vs_twin": torch.equal(y, twin),
                  "combine_vs_plain": bool((gap <= room).all())}
            for n, (a, b) in (("moe_slots", (slot, want_slot)),
                              ("moe_scatter", (buf, want)),
                              ("moe_combine", (y, twin))):
                err[n] = max(err[n], float((a.float() - b.float()).abs()
                                           .max()))
            dropped = 1.0 - float(want_keep.float().mean())
            print(f"  moe dispatch {label} T={T} k={k} E={E} C={C} d={d} "
                  f"{tag}: dropped share {dropped:.4f}, combine vs plain "
                  f"max abs gap {float(gap.max()):.3e} (bitwise "
                  f"{float((y == plain).double().mean()):.4f}); "
                  + ", ".join(f"{n} {'ok' if v else 'FAIL'}"
                              for n, v in ok.items()))
            if not all(ok.values()):
                raise AssertionError(f"moe dispatch {label} {tag}: {ok}")
            out[f"{label}/{tag}"] = dropped
    return out, err


def time_moe_dispatch() -> dict:
    """Each moe dispatch kernel at the cell's shape (bf16) beside the plain
    version's time and its bound: bytes at the HBM rate, each input byte
    read once and each output byte written once.  Slots: the experts read
    (8 B a route), the slots and keep written (9 B a route) and the
    counts.  Scatter: x read once, the (E, C, d) buffer written once, the
    slots read.  Combine: each kept route's expert row read once, y
    written once, the slots and weights read."""
    import torch
    from repro_torch.kernels.moe_dispatch import kernel as mk, ref as mr
    from repro_torch.models import moe
    T, k, E, d, _ = MOE_CELL
    dt = torch.bfloat16
    x, flat_e, flat_w, C = moe_case(MOE_CELL, dt)
    es, n = x.element_size(), T * k
    slot, keep, counts = mk.moe_slots(flat_e, E, C)
    kept = int(keep.sum())
    buf = mk.moe_scatter(x, slot, counts, E, C, k)
    eo = torch.randn(E, C, d, device=DEVICE).to(dt)
    work = {"moe_slots": n * 8 + n * 9 + E * 4,
            "moe_scatter": T * d * es + E * C * d * es + n * 8,
            "moe_combine": kept * d * es + T * d * es + n * (8 + es)}
    kernel = {
        "moe_slots": lambda: mk.moe_slots(flat_e, E, C),
        "moe_scatter": lambda: mk.moe_scatter(x, slot, counts, E, C, k),
        "moe_combine": lambda: mk.moe_combine(buf, slot, flat_w, k)}
    plain = {
        "moe_slots": lambda: mr.slots_ref(flat_e, E, C),
        "moe_scatter": lambda: moe_plain_dispatch(x, flat_e, E, C, k),
        "moe_combine": lambda: moe._combine(eo, slot, keep, flat_w, T, 1,
                                            k)}
    out = {}
    for name in kernel:
        split = device_split(kernel[name], iters=20)
        ms = sum(split.values())
        plain_ms = device_ms(plain[name], iters=10)
        b_ms, by = bound_ms(work[name], 0.0)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": None,
                     "split_ms": {short_name(kn): v
                                  for kn, v in split.items()}}
        print(f"  {name} bf16 T={T} k={k} E={E} C={C} d={d}: kernel "
              f"{ms * 1e3:9.2f} us  plain {plain_ms * 1e3:9.2f} us  bound "
              f"{b_ms * 1e3:7.2f} us ({by}, {work[name] / 1e6:.1f} MB; "
              f"{b_ms / ms:.1%} of it); by kernel "
              + ", ".join(f"{short_name(kn)} {v * 1e3:.2f} us"
                          for kn, v in split.items()))
    print("  (the plain scatter's time includes its slots; no single "
          "PyTorch call computes any of the three)")
    return out


def moe_dispatch_path() -> dict:
    """Phase 8's moe dispatch kernels: checked, then timed."""
    import torch
    shares, err = check_moe_dispatch()
    torch.cuda.synchronize()
    return {"dropped_share": shares, "max_abs_err": err,
            "timing": time_moe_dispatch()}


def zoo_prefill(cfg, label: str, iters: int = 3, seq: int = ZOO_S):
    """The main path of the zoo: ``make_prefill_step`` on B x S prompts at
    full width, weights from the port's init (one generator seed), inputs
    from ``models.inputs.materialize`` (tokens; frame embeddings for audio;
    patch embeddings and M-RoPE positions for vlm).  Counts are set to 0
    just before the first prefill and read just after it; returns (model,
    params, inputs, launches of the zoo and moe kernels, ms per prefill,
    busy share)."""
    import torch
    from repro_torch.models import build_model, inputs as zin
    from repro_torch.training.step import make_prefill_step
    model = build_model(cfg, DEVICE)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    n_params = model.param_count(params)
    batch = zin.materialize(zin.prefill_specs(cfg, ZOO_B, seq), cfg, seed=1,
                            device=DEVICE)
    step = make_prefill_step(model)
    reset_all_launches()
    logits = step(params, batch)
    sync()
    launches = all_launches()
    if tuple(logits.shape) != (ZOO_B, seq, cfg.vocab_padded) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{label}: prefill logits of shape "
                             f"{tuple(logits.shape)} are not all finite")
    del logits
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        step(params, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    busy = profile_step(lambda: step(params, batch), f"{label} prefill")
    print(f"  {label} prefill: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({cfg.param_dtype}, compute "
          f"{cfg.dtype}), B={ZOO_B} x S={seq} ({', '.join(batch)}): "
          f"{ms:.1f} ms per prefill (median of {iters}, first "
          f"{times[0]:.1f}), {ZOO_B * seq / ms * 1e3:.0f} prompt tokens/s; "
          f"launches { {n: launches[n] for n in ZOO + MOE} }")
    return (model, params, batch, {n: launches[n] for n in ZOO + MOE}, ms,
            busy)


def profile_step(fn, label: str, top: int = 10):
    """One call of ``fn`` under torch.profiler: wall, device busy share,
    and the kernels that take the most device time; returns the busy share
    (None if the profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = _device_events(prof)
    dev_us = _device_us(events)
    if dev_us <= 0:
        print(f"  {label}: the profiler recorded no device time")
        return None
    print(f"  {label} under the profiler: wall {wall * 1e3:.1f} ms, device "
          f"busy {dev_us / 1e3:.2f} ms -> busy share "
          f"{dev_us / 1e6 / wall:.3f} (the profile read in "
          f"{time.perf_counter() - t1:.1f} s)")
    print_top_kernels(events, top)
    return dev_us / 1e6 / wall


def zoo_kernel_vs_cache(model, params, label: str, prompt: int = CACHE_PROMPT,
                        opts=None, layers=None):
    """The reference's decode-matches-forward test at full width on the
    model's first layers (``layers``: per dtype, CACHE_LAYERS by default):
    the full-sequence forward through the kernel, its logits at the last
    position, against ``serving.decode.prefill`` walking the cache (or the
    RWKV or mamba state) token by token with no kernel; at the config's
    bf16 and at f32, from the same params, text tokens only, both paths
    under ``opts``."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.decode import prefill
    from repro_torch.utils.tree import tree_map
    layers = layers or {}
    tokens = torch.randint(0, model.cfg.vocab_size, (1, prompt),
                           generator=torch.Generator().manual_seed(2)
                           ).to(DEVICE)
    name = label
    for dtype in ("bfloat16", "float32"):
        n = min(layers.get(dtype, CACHE_LAYERS), model.cfg.num_layers)
        cut = {**params, "layers": tree_map(lambda a: a[:n],
                                            params["layers"])}
        label = f"{name} ({n} of {model.cfg.num_layers} layers)"
        m = build_model(model.cfg.replace(dtype=dtype, num_layers=n),
                        DEVICE)
        (full, _), r_full = moe_routes(
            lambda: m.forward(cut, {"tokens": tokens}, opts))
        sync()
        t0 = time.perf_counter()
        (last, _, _), r_loop = moe_routes(
            lambda: prefill(m, cut, tokens, context_len=prompt,
                            opts=opts))
        sync()
        loop_ms = (time.perf_counter() - t0) * 1e3
        moved = ""
        if model.cfg.num_experts:
            # (layers, tokens, k) from both paths: the loop routes token by
            # token, every layer at each step
            kf = torch.stack(r_full)
            kl = torch.stack(r_loop).reshape(prompt, len(r_full), -1)
            diff = (kf != kl.transpose(0, 1)).any(-1).any(0)
            moved = (f"; routes moved for {float(diff.float().mean()):.4f} "
                     f"of the tokens (the last: {bool(diff[-1])})")
        V = model.cfg.vocab_size          # the padded slots hold -1e9
        a, b = full[:, -1, :V].float(), last[:, 0, :V].float()
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
              f"{prompt}-token prompt: {what}, argmax agrees {agree:.2f}"
              f"{moved}; token loop {loop_ms:.0f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {dtype}: the kernel path and the "
                                 "cache path disagree")


def zoo_serving(rwkv_model, rwkv_params) -> dict:
    """``launch/serve.py`` on Llama-3.2-1B as a user runs it (greedy), and
    the same ``generate`` on the 4-layer RWKV6-7B; tokens per second."""
    from repro_torch.launch import serve
    argv = ["--device", DEVICE, "--arch", "llama3.2-1b", "--batch", "4",
            "--prompt-len", "64", "--max-new", "32"]
    sync()
    t0 = time.perf_counter()
    if serve.main(argv) != 0:
        raise AssertionError("launch/serve.py failed")
    sync()
    llama_s = time.perf_counter() - t0
    print(f"  serve.main {' '.join(argv)}: {llama_s:.2f} s with init (its "
          f"own tok/s line above)")
    reset_all_launches()
    rate = zoo_generate(rwkv_model, rwkv_params,
                        f"rwkv6-7b ({RWKV_LAYERS} layers)")
    print(f"  launches in generate { {n: all_launches()[n] for n in ZOO} } "
          f"(decode runs no kernel)")
    return {"llama_serve_s": llama_s, "rwkv_tok_s": rate}


def moe_dropped_shares(fn) -> list:
    """The share of routed tokens that the scatter path drops for
    capacity, per moe layer, over one call of ``fn``: each layer's
    ``moe.moe_scatter`` call runs under its own recording, whose
    ``moe.dropped_routes`` over ``moe.routes`` is the layer's share (a
    read back per layer, so never inside a timed run)."""
    from repro_torch.models import moe
    from repro_torch.utils import trace
    plain, shares = moe.moe_scatter, []

    def recorded(params, cfg, x):
        with trace.record() as rec:
            out = plain(params, cfg, x)
        shares.append(rec.counters["moe.dropped_routes"]
                      / rec.counters["moe.routes"])
        return out

    moe.moe_scatter = recorded
    try:
        fn()
    finally:
        moe.moe_scatter = plain
    return shares


def moe_routes(fn):
    """``fn()``'s result and the set of experts each moe layer picked for
    each token (``moe.top_k``'s indices in ascending order, one (T, k)
    tensor a layer: an order that differs within the set moves no
    output)."""
    import torch
    from repro_torch.models import moe
    plain, routes = moe.top_k, []

    def recorded(probs, k):
        w, e = plain(probs, k)
        routes.append(torch.sort(e, dim=-1).values)
        return w, e

    moe.top_k = recorded
    try:
        out = fn()
    finally:
        moe.top_k = plain
    return out, routes


def mamba_loop_share(model, params, batch) -> dict:
    """The mamba branch's and its time loop's (``selective_scan``) share
    of one hybrid prefill, read inside that prefill: CUDA events recorded
    around every call of ``mamba.mamba_full`` and ``mamba.selective_scan``
    (the loop issues from the host, so the events span its issue), summed
    over the layers, over the prefill's own wall."""
    import torch
    from repro_torch.models import mamba as mb
    plain = {"mamba_full": mb.mamba_full, "selective_scan": mb.selective_scan}
    spans = {name: [] for name in plain}

    def timed(name):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = plain[name](*args)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    for name in plain:
        setattr(mb, name, timed(name))
    try:
        sync()
        t0 = time.perf_counter()
        model.forward(params, batch)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in plain.items():
            setattr(mb, name, fn)
    ms = {name: sum(s.elapsed_time(e) for s, e in ev)
          for name, ev in spans.items()}
    out = {"mamba_branch_ms": ms["mamba_full"],
           "scan_ms": ms["selective_scan"], "timed_prefill_ms": wall,
           "mamba_share": ms["mamba_full"] / wall,
           "scan_share": ms["selective_scan"] / wall}
    print(f"  {model.cfg.name} mamba, inside one prefill of {wall:.1f} ms: "
          f"the branch {ms['mamba_full']:.1f} ms ({out['mamba_share']:.1%}), "
          f"its time loop over S={ZOO_S} steps (selective_scan) "
          f"{ms['selective_scan']:.1f} ms ({out['scan_share']:.1%}), over "
          f"{len(spans['selective_scan'])} layers (CUDA events)")
    return out


def zoo_generate(model, params, label: str, batch: int = 4, plen: int = 64,
                 new: int = 32) -> float:
    """Greedy ``generate`` on the loaded params, B x prompt tokens, new
    tokens per second (the prompt fed token by token, as the launcher
    does)."""
    import torch
    from repro_torch.serving import generate
    prompt = torch.randint(0, model.cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(3)
                           ).to(DEVICE)
    sync()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, max_new=new,
                   context_len=plen + new)
    sync()
    sec = time.perf_counter() - t0
    if tuple(out.shape) != (batch, new) or int(out.max()) >= \
            model.cfg.vocab_padded or int(out.min()) < 0:
        raise AssertionError(f"{label} generate gave {tuple(out.shape)} "
                             "tokens out of the vocab")
    print(f"  {label} generate B={batch} prompt={plen} new={new}: "
          f"{sec:.2f} s, {batch * new / sec:.1f} new tok/s (prompt fed "
          f"token by token)")
    return batch * new / sec


def family_path(arch: str) -> dict:
    """One family at full width and depth: (8b) the prefill, with the flash
    kernel launched once a layer, the moe scatter's dropped share and the
    dense dispatch's time, the mamba loop's share; (8c) the kernel path
    against the cache path (moe under ``dense``: the scatter path's
    capacity depends on the tokens routed at once, so it drops tokens in
    the forward and none a step); (8d) ``generate`` for the decoders and
    ``launch/serve.py`` on hymba-1.5b; then the weights are freed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe
    cfg = get_config(arch)
    seq = HUBERT_S if cfg.family == "audio" else ZOO_S
    iters = HYMBA_PREFILL_ITERS if cfg.family == "hybrid" else 3
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    model, params, batch, launch, ms, busy = zoo_prefill(cfg, arch,
                                                         iters=iters, seq=seq)
    lap("prefill")
    want = {**dict.fromkeys(ZOO + MOE, 0),
            "flash_attention_bh": cfg.num_layers}
    if cfg.num_experts:
        want.update(dict.fromkeys(MOE, cfg.num_layers))
    if launch != want:
        raise AssertionError(f"{arch} prefill launches {launch}: expected "
                             f"{want}, one flash attention a layer and on "
                             f"a moe model one call of each moe dispatch "
                             f"wrapper a layer")
    out = {"layers": cfg.num_layers, "launches": launch["flash_attention_bh"],
           "moe_launches": {n: launch[n] for n in MOE},
           "prefill_ms": ms, "prompt_tok_s": ZOO_B * seq / ms * 1e3,
           "busy": busy}
    if cfg.num_experts:
        shares = moe_dropped_shares(lambda: model.forward(params, batch))
        out["dropped_share"] = float(np.mean(shares))
        dense = {"moe_dispatch": "dense"}
        model.forward(params, batch, dense)
        sync()
        t0 = time.perf_counter()
        model.forward(params, batch, dense)
        sync()
        out["dense_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"  {arch} scatter dispatch at T = {ZOO_B * seq} tokens: "
              f"capacity {moe.capacity(ZOO_B * seq, cfg)} slots an expert, "
              f"dropped share {out['dropped_share']:.4f} (per layer {min(shares):.4f}-{max(shares):.4f}); the dense "
              f"dispatch's prefill {out['dense_prefill_ms']:.1f} ms")
    if cfg.family == "hybrid":
        out.update(mamba_loop_share(model, params, batch))
    lap("8b rest")
    if not cfg.is_encoder_only:
        opts = {"moe_dispatch": "dense"} if cfg.num_experts else None
        zoo_kernel_vs_cache(model, params, arch, opts=opts,
                            layers={"bfloat16": cfg.num_layers}
                            if cfg.num_experts else None)
        if cfg.num_experts:
            toks = torch.randint(0, cfg.vocab_size, (1, CACHE_PROMPT),
                                 generator=torch.Generator().manual_seed(2)
                                 ).to(DEVICE)
            shares = moe_dropped_shares(
                lambda: model.forward(params, {"tokens": toks}))
            print(f"  {arch}: the scatter path over the same "
                  f"{CACHE_PROMPT}-token prompt drops {np.mean(shares):.4f} "
                  f"of its routes (the cache path: none, B tokens a step)")
        lap("8c")
        out["new_tok_s"] = zoo_generate(model, params, arch)
        lap("generate")
    del model, params, batch
    torch.cuda.empty_cache()
    if cfg.family == "hybrid":
        # the launcher's path on a hybrid; 8d's generate timed it in full
        argv = ["--device", DEVICE, "--arch", arch, "--batch", "4",
                "--prompt-len", "16", "--max-new", "8"]
        if serve.main(argv) != 0:
            raise AssertionError("launch/serve.py failed")
        torch.cuda.empty_cache()
        lap("launcher")
    print(f"  {arch} seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    return out


def zoo_card_vs_cpu(archs):
    """(8e) The reduced ``archs`` (llama, granite and hymba with 2 kv
    heads) at f32 and bf16: the card's path against the CPU twins from one
    set of params and one ``materialize`` seed, logits over the real
    vocabulary and, for the decoders, greedy tokens (equal at f32).

    moe at bf16: a router probability that rounds the other way on one
    side moves a token's k-th expert, and the token's output with it (one
    moved token of 256 is ~2.6% of the logits' norm).  So granite runs
    the dense dispatch there (no capacity: a moved route changes no other
    token's drop), its routes are recorded on both sides, the tokens whose
    routes moved in any layer are counted (at most MOE_MOVED_MAX of them)
    and the 3% bound holds over the others."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, inputs as zin
    from repro_torch.serving import generate
    from repro_torch.utils.tree import tree_map
    for arch in archs:
        cfg = get_config(arch).reduced()
        if arch in REDUCED_KV:
            cfg = cfg.replace(num_kv_heads=REDUCED_KV[arch])
        for dtype in ("float32", "bfloat16"):
            c = cfg.replace(dtype=dtype)
            m_gpu, m_cpu = build_model(c, DEVICE), build_model(c, "cpu")
            p_cpu = m_cpu.init(torch.Generator().manual_seed(4))
            p_gpu = tree_map(lambda t: t.to(DEVICE), p_cpu)
            batch = zin.materialize(zin.prefill_specs(c, 2, 128), c, seed=5,
                                    device="cpu")
            routed = bool(c.num_experts) and dtype == "bfloat16"
            opts = {"moe_dispatch": "dense"} if routed else None
            (want, aux_c), r_cpu = moe_routes(
                lambda: m_cpu.forward(p_cpu, batch, opts))
            (got, aux_g), r_gpu = moe_routes(lambda: m_gpu.forward(
                p_gpu, {k: v.to(DEVICE) for k, v in batch.items()}, opts))
            V = c.vocab_size
            got, want = got[..., :V].float().cpu(), want[..., :V].float()
            kept = torch.ones(got.shape[:2], dtype=torch.bool)
            for a, b in zip(r_cpu, r_gpu):
                kept &= (a == b.cpu()).all(-1).reshape(kept.shape)
            moved = 1.0 - float(kept.float().mean())
            if routed:
                got, want = got[kept], want[kept]
            same = 1.0
            if not c.is_encoder_only:
                toks = batch["tokens"][:, :16]
                t_cpu = generate(m_cpu, p_cpu, toks, max_new=16,
                                 context_len=32)
                t_gpu = generate(m_gpu, p_gpu, toks.to(DEVICE), max_new=16,
                                 context_len=32).cpu()
                same = float((t_cpu == t_gpu).float().mean())
            if dtype == "float32":
                err, rel = rel_err(got, want)
                ok = rel <= ZOO_CPU_F32_RTOL and same == 1.0
                what = f"logits rel {rel:.3e} (tol {ZOO_CPU_F32_RTOL:.0e})"
            else:
                frob = float((got - want).norm() / want.norm())
                ok = frob <= ZOO_CPU_BF16_FROB and moved <= MOE_MOVED_MAX
                what = (f"logits relative Frobenius {frob:.3e} (tol "
                        f"{ZOO_CPU_BF16_FROB})")
            if routed:
                what += (f" over the tokens whose routes agree (dense "
                         f"dispatch); routes moved for {moved:.4f} of the "
                         f"tokens (at most {MOE_MOVED_MAX})")
            elif c.num_experts:
                what += f"; routes moved for {moved:.4f} of the tokens"
            must = " (must be 1)" if dtype == "float32" else ""
            greedy = ("encoder-only, no decode" if c.is_encoder_only else
                      f"greedy tokens equal {same:.3f}{must}")
            print(f"  {c.name} reduced {dtype}: card vs CPU {what}; aux "
                  f"{float(aux_g):.6f} vs {float(aux_c):.6f}; {greedy} "
                  f"{'ok' if ok else 'FAIL'}")
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
    timing["moe"] = moe_dispatch_path()
    llama_cfg, rwkv_cfg = zoo_configs()
    model, params, _, fa_launch, llama_ms, _ = zoo_prefill(llama_cfg,
                                                           "llama3.2-1b")
    if fa_launch != {**dict.fromkeys(ZOO + MOE, 0),
                     "flash_attention_bh": llama_cfg.num_layers}:
        raise AssertionError(f"llama prefill launches {fa_launch}: expected "
                             f"one flash attention per layer")
    zoo_kernel_vs_cache(model, params, "llama3.2-1b")
    del model, params
    torch.cuda.empty_cache()
    r_model, r_params, _, wk_launch, rwkv_ms, _ = zoo_prefill(
        rwkv_cfg, f"rwkv6-7b ({RWKV_LAYERS} of 32 layers)")
    if wk_launch != {**dict.fromkeys(ZOO + MOE, 0),
                     "wkv6_bh": rwkv_cfg.num_layers}:
        raise AssertionError(f"rwkv6 prefill launches {wk_launch}: expected "
                             f"one wkv6 per layer")
    zoo_kernel_vs_cache(r_model, r_params, "rwkv6-7b")
    serving = zoo_serving(r_model, r_params)
    del r_model, r_params
    torch.cuda.empty_cache()
    zoo_card_vs_cpu(("llama3.2-1b", "rwkv6-7b"))
    launches = {"flash_attention_bh": fa_launch["flash_attention_bh"],
                "wkv6_bh": wk_launch["wkv6_bh"]}
    print(f"  zoo phase (llama, rwkv6) wall time {time.perf_counter() - t0:.1f}"
          f" s; prefill llama3.2-1b {llama_ms:.1f} ms, rwkv6-7b "
          f"({RWKV_LAYERS} layers) {rwkv_ms:.1f} ms; serving {serving}")
    families = {}
    for arch in FAMILIES:
        print(f"  -- {arch} (full width and depth)")
        t1 = time.perf_counter()
        families[arch] = family_path(arch)
        print(f"  {arch} wall time {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    zoo_card_vs_cpu(FAMILIES)
    print(f"  families card vs CPU wall time {time.perf_counter() - t1:.1f} s")
    print(f"  zoo phase wall time {time.perf_counter() - t0:.1f} s; "
          f"families {json.dumps(families)}")
    return timing, launches, families


# ---------------------------------------------------------------------------
# phase 10: the zoo's training path
# ---------------------------------------------------------------------------

# Llama-3.2-1B as configured (16 layers, d 2048, vocab 128 256, tied; bf16
# compute on f32 params), B x S tokens: S > 1024 takes _sdpa_chunked
TRAIN_B, TRAIN_S = 2, 2048
TRAIN_STEPS = 4                 # timed, after one warm-up step
TRAIN_LR = 3e-4                 # the launcher's AdamW peak
# remat recomputes the same ops on the same inputs: bitwise is expected,
# 1e-6 of the largest magnitude is the bound
REMAT_RTOL = 1e-6
# the fused head sums the same terms chunk by chunk (the reference's
# test_numerics bound)
FUSED_HEAD_RTOL = 1e-5
# card vs CPU, one AdamW step at f32 from one param tree: the CPU tests'
# bounds against JAX (loss 1e-5 relative, params 1e-4 of the largest)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_RTOL = 1e-4
TRAIN_CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_train_ckpt")
EXAMPLES = (("quickstart", []), ("serve_batched", []),
            ("uav_fl_sim", ["--rounds", "2"]))


def gb(nbytes: float) -> float:
    return nbytes / 2 ** 30


def token_batch(cfg, b: int, s: int, seed: int = 0, device=None):
    """``b`` sequences of the synthetic token stream on ``device``."""
    import torch
    from repro_torch.data import make_token_stream
    ds = make_token_stream(b, s, vocab=cfg.vocab_size, seed=seed)
    dev = DEVICE if device is None else device
    return {"tokens": torch.tensor(ds.x, device=dev),
            "labels": torch.tensor(ds.y, device=dev)}


def add_launches(total: dict, label: str) -> None:
    """Add the zoo and moe kernels' counts since the last reset to
    ``total``."""
    got = all_launches()
    for n in ZOO + MOE:
        total[n] += got[n]
        if got[n]:
            raise AssertionError(f"{label}: {n} launched {got[n]} times in "
                                 f"training (it has no backward)")


def rel_tree_err(got, want) -> float:
    """Largest |got - want| over the largest |want|, over a tree's leaves."""
    from repro_torch.utils.tree import tree_leaves
    scale = max(float(t.abs().max()) for t in tree_leaves(want))
    err = max(float((a.to(b.device) - b).abs().max())
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    return err / max(scale, 1e-30)


def train_llama(train_launches: dict) -> dict:
    """(10a) ``make_train_step`` on Llama-3.2-1B at full width and depth
    with AdamW + cosine and a clip of 1.0: one warm-up and TRAIN_STEPS
    timed steps on one fixed batch, then one step under the profiler and
    a no_grad prefill; (10b) loss and grads under remat none/full/dots and
    the fused head at the same shape.  Returns the numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine
    from repro_torch.training import (create_train_state, make_prefill_step,
                                      make_train_step)
    from repro_torch.training.step import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg, DEVICE)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    p0 = tree_map(lambda t: t.cpu(), params)
    batch = token_batch(cfg, TRAIN_B, TRAIN_S)
    opt = adamw(cosine(TRAIN_LR, 1, 100))
    state = create_train_state(params, opt)
    del params
    step = make_train_step(model, opt, grad_clip=1.0)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    state, met = step(state, batch)                       # warm-up
    losses, times = [float(met["loss"])], []
    for _ in range(TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    add_launches(train_launches, "llama3.2-1b train steps")
    ms = float(np.median(times))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"llama3.2-1b train losses {losses}: not "
                             f"finite, or the last not below the first")
    still = [i for i, (a, b) in enumerate(zip(tree_leaves(p0),
                                              tree_leaves(state.params)))
             if torch.equal(a, b.cpu())]
    if still:
        raise AssertionError(f"param leaves {still} did not move")
    n_params = model.param_count(state.params)
    print(f"  llama3.2-1b train step: {cfg.num_layers} layers, d="
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params (f32, compute "
          f"{cfg.dtype}), B={TRAIN_B} x S={TRAIN_S}, AdamW + cosine, clip "
          f"1.0: {ms:.1f} ms per step (median of {TRAIN_STEPS}: "
          + ", ".join(f"{t:.1f}" for t in times)
          + f"), {TRAIN_B * TRAIN_S / ms * 1e3:.0f} training tokens/s; "
          f"peak {gb(peak):.2f} GiB; losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; every one of {len(tree_leaves(p0))} param leaves moved; "
          f"launches { {n: 0 for n in ZOO + MOE} }")
    del p0
    busy = profile_step(lambda: step(state, batch), "llama3.2-1b train step")
    reset_all_launches()
    make_prefill_step(model)(state.params, {"tokens": batch["tokens"]})
    sync()
    pre = {n: all_launches()[n] for n in ZOO}
    if pre != {"flash_attention_bh": cfg.num_layers, "wkv6_bh": 0}:
        raise AssertionError(f"no_grad prefill after training launched "
                             f"{pre}: expected one flash attention a layer")
    print(f"  no_grad prefill after the steps: launches {pre}")

    # (10b) the same params and batch under each remat policy, and the
    # fused head
    peaks, grad_ms, grads0, loss0 = {}, {}, None, None
    for label, opts in (("none", None), ("full", {"remat": "full"}),
                        ("dots", {"remat": "dots"}),
                        ("fused_head", {"fused_head": True})):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t1 = time.perf_counter()
        (loss, _), grads = value_and_grad(model, state.params, batch, opts)
        sync()
        grad_ms[label] = (time.perf_counter() - t1) * 1e3
        peaks[label] = (torch.cuda.max_memory_allocated(), base)
        add_launches(train_launches, f"llama3.2-1b value_and_grad {label}")
        loss = float(loss)
        if grads0 is None:
            grads0, loss0 = grads, loss
            continue
        lerr = abs(loss - loss0) / abs(loss0)
        gerr = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(tree_leaves(grads), tree_leaves(grads0)))
        same = loss == loss0 and all(torch.equal(a, b) for a, b in zip(
            tree_leaves(grads), tree_leaves(grads0)))
        tol = FUSED_HEAD_RTOL if label == "fused_head" else REMAT_RTOL
        ok = lerr <= tol and (label == "fused_head" or gerr <= tol)
        print(f"  {label}: loss {loss:.6f} vs {loss0:.6f} (relative "
              f"{lerr:.2e}), grads within {gerr:.2e} of the largest per "
              f"leaf, bitwise {same} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} moved the loss or the grads")
        del grads
    print(f"  peak memory of loss + grads at B={TRAIN_B} x S={TRAIN_S} (on "
          f"top of the resident state): "
          + ", ".join(f"{k} {gb(p):.2f} GiB ({gb(p - b):.2f} above "
                      f"{gb(b):.2f})" for k, (p, b) in peaks.items()))
    print("  loss + grads ms (one call each, host clock): "
          + ", ".join(f"{k} {v:.1f}" for k, v in grad_ms.items())
          + f"; the rest of a step (clip, AdamW, apply) ~"
          f"{ms - grad_ms['none']:.1f} ms")
    del grads0, state
    torch.cuda.empty_cache()
    return {"ms": ms, "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3,
            "peak_gib": gb(peak), "busy": busy, "losses": losses,
            "remat_peak_gib": {k: gb(p) for k, (p, _) in peaks.items()},
            "grad_ms": grad_ms}


def train_resume(train_launches: dict) -> None:
    """(10c) 2 steps, a checkpoint, a restore into a fresh state and 2
    more steps against 4 steps without the break (reduced Llama-3.2-1B,
    one batch a step): equal bit for bit.  Then ``launch/train.py`` on the
    card, 20 steps with a checkpoint every 10, and a second run resumed
    from its step-10 checkpoint: the step-20 checkpoints are equal byte
    for byte."""
    import contextlib
    import io

    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, DEVICE)
    opt = adamw(cosine(TRAIN_LR, 1, 4), weight_decay=0.1)
    step = make_train_step(model, opt, grad_clip=1.0)
    batches = [token_batch(cfg, 2, 128, seed=i) for i in range(4)]
    fresh = lambda seed: create_train_state(
        model.init(torch.Generator(DEVICE).manual_seed(seed)), opt)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    reset_all_launches()
    whole = fresh(0)
    for b in batches:
        whole, _ = step(whole, b)
    broken = fresh(0)
    for b in batches[:2]:
        broken, _ = step(broken, b)
    save_checkpoint(os.path.join(TRAIN_CKPT_DIR, "state"), 2, broken)
    broken = restore_checkpoint(os.path.join(TRAIN_CKPT_DIR, "state"), 2,
                                fresh(1))
    for b in batches[2:]:
        broken, _ = step(broken, b)
    sync()
    add_launches(train_launches, "resume steps")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                 tree_leaves(broken)))
    print(f"  2 steps + checkpoint + restore + 2 steps vs 4 steps "
          f"(reduced llama3.2-1b, {len(tree_leaves(whole))} leaves: params, "
          f"moments, steps): bitwise {same}")
    if not same:
        raise AssertionError("the resumed state differs from the "
                             "uninterrupted one")
    argv = ["--device", DEVICE, "--reduced", "--arch", "llama3.2-1b",
            "--steps", "20",
            "--batch", "2", "--seq", "128", "--ckpt-every", "10",
            "--log-every", "10"]
    runs = {}
    for label in ("whole", "resumed"):
        d = os.path.join(TRAIN_CKPT_DIR, label)
        if label == "resumed":
            shutil.copytree(os.path.join(TRAIN_CKPT_DIR, "whole", "10"),
                            os.path.join(d, "10"))
        out = io.StringIO()
        reset_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train.main(argv + ["--ckpt-dir", d])
        sync()
        add_launches(train_launches, f"launch/train.py {label}")
        runs[label] = (out.getvalue(), time.perf_counter() - t0)
        with open(os.path.join(d, "20", "checkpoint.msgpack"), "rb") as f:
            runs[label] += (f.read(),)
    text, sec, _ = runs["resumed"]
    equal = runs["whole"][2] == runs["resumed"][2]
    print(f"  launch/train.py --reduced on the card: 20 steps in "
          f"{runs['whole'][1]:.1f} s ("
          + runs["whole"][0].strip().splitlines()[-1]
          + f"); resumed from step 10 in {sec:.1f} s, step-20 checkpoints "
          f"equal byte for byte {equal}")
    if "restored checkpoint at step 10" not in text or not equal:
        raise AssertionError(f"launch/train.py did not resume to the same "
                             f"state:\n{text}")


def train_card_vs_cpu(train_launches: dict) -> None:
    """(10d) every family of ``ARCH_IDS`` reduced (llama, granite and hymba
    with 2 kv heads), f32: one AdamW step (clip 1.0) on the card and on
    the CPU from one param tree and one batch."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build_model, inputs as zin
    from repro_torch.optim import adamw, cosine
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.utils.tree import tree_map
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        if arch in REDUCED_KV:
            cfg = cfg.replace(num_kv_heads=REDUCED_KV[arch])
        batch = zin.materialize(zin.train_specs(cfg, 2, 64), cfg, seed=2,
                                device="cpu")
        p_cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
        out = []
        for dev in ("cpu", DEVICE):
            model = build_model(cfg, dev)
            opt = adamw(cosine(TRAIN_LR, 1, 4), weight_decay=0.1)
            state = create_train_state(tree_map(lambda t: t.to(dev), p_cpu),
                                       opt)
            reset_all_launches()
            state, met = make_train_step(model, opt, grad_clip=1.0)(
                state, {k: v.to(dev) for k, v in batch.items()})
            add_launches(train_launches, f"{arch} card step")
            out.append((float(met["loss"]), state))
        (l_cpu, s_cpu), (l_gpu, s_gpu) = out
        lerr = abs(l_gpu - l_cpu) / abs(l_cpu)
        perr = rel_tree_err(s_gpu.params, s_cpu.params)
        ok = lerr <= TRAIN_LOSS_RTOL and perr <= TRAIN_PARAM_RTOL
        print(f"  {arch} reduced f32, one AdamW step: loss {l_gpu:.6f} vs "
              f"CPU {l_cpu:.6f} (relative {lerr:.2e}, tol "
              f"{TRAIN_LOSS_RTOL:.0e}), params within {perr:.2e} of the "
              f"largest (tol {TRAIN_PARAM_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{arch}: card and CPU train steps "
                                 "disagree")


def run_examples() -> dict:
    """(10e) the three example twins as subprocesses on the card, started
    together (each is a path check; its seconds are its own start to its
    exit), each to a zero exit; returns their wall seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = {}
    for name, argv in EXAMPLES:
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    secs = {}
    try:
        for name, argv in EXAMPLES:
            t0, proc = procs[name]
            out, err = proc.communicate(timeout=300)
            secs[name] = time.perf_counter() - t0
            last = (out.strip().splitlines() or [""])[-1]
            print(f"  examples/{name} {' '.join(argv)}: exit "
                  f"{proc.returncode} in {secs[name]:.1f} s; last line: "
                  f"{last}")
            if proc.returncode != 0:
                raise AssertionError(f"example {name} failed:\n"
                                     f"{out[-3000:]}\n{err[-3000:]}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return secs


def train_path():
    """Phase 10; returns (the zoo kernels' launches over every training
    step of the phase, which must be 0, and the Llama-3.2-1B numbers)."""
    import torch
    t0 = time.perf_counter()
    train_launches = dict.fromkeys(ZOO + MOE, 0)
    numbers = train_llama(train_launches)
    torch.cuda.empty_cache()
    train_resume(train_launches)
    train_card_vs_cpu(train_launches)
    numbers["examples_s"] = run_examples()
    print(f"  train phase wall time {time.perf_counter() - t0:.1f} s; zoo "
          f"kernel launches in training {train_launches}")
    return train_launches, numbers


# ---------------------------------------------------------------------------
# phase 11: ranks on the card (OpportunisticSync, the sweep over ranks)
# ---------------------------------------------------------------------------

# Llama-3.2-1B at full width (d 2048, 32 q / 8 kv, vocab 128 256, tied;
# bf16 compute on f32 params) with OPP_LAYERS of its 16 layers: a pod's f32
# params, grads, snapshot and the round's copies take ~10 GiB at 4 layers
# and ~22 GiB at 16, so four pods fit on one 80 GB card only cut in depth
OPP_PODS, OPP_LAYERS = 4, 4
OPP_B, OPP_S = 2, 512           # per inner step and pod
OPP_REDUCED_S = 64              # card vs CPU, reduced llama at f32
OPP_CFG = dict(inner_steps=6, budget=2, outage_prob=0.3, rate0=1.0)
OPP_LR = 1e-2
# one round per scheme (cut from 3 opt rounds to keep the script within
# half its time limit)
OPP_SCHEMES = ("opt", "async", "discard")
OPP_TRACE_SEED = 7
# card vs CPU at f32: the zoo's training bounds (summation order only)
OPP_LOSS_RTOL, OPP_PARAM_RTOL = 1e-5, 1e-4
SWEEP_RANKS = 2                 # the Fig. 3(b) panel's 2 seeds, one a rank
OPP_TIMEOUT_S = 300             # bounds each collective of a rank
# the ranks' rendezvous files and results (git-ignored)
RANKS_DIR = os.path.join(HERE, "build", "ranks")


def opp_trace():
    """The phase's channel trace, drawn on the CPU as every rank draws it:
    (rates, outages, arrived) of shape (rounds, e+1, pods)."""
    import torch
    from repro_torch.core.opportunistic_sync import (OppSyncConfig,
                                                     channel_trace)
    return channel_trace(OppSyncConfig(**OPP_CFG),
                         torch.Generator().manual_seed(OPP_TRACE_SEED),
                         OPP_PODS, len(OPP_SCHEMES))


def host_decisions(rates, outages, pod: int) -> list:
    """Alg. 2's snapshot decisions recomputed on the host in numpy f32 from
    the trace: per round, the pod's (snapshot_step, tau_extra) at the entry
    of each inner step, as the rank records them."""
    from repro_torch.core.opportunistic_sync import OppSyncConfig
    cfg = OppSyncConfig(**OPP_CFG)
    e, per = cfg.inner_steps, cfg.schedule_period()
    one, tiny = np.float32(cfg.payload), np.float32(1e-9)
    out = []
    for r in range(len(OPP_SCHEMES)):
        snap, te, seen = -1, np.float32(cfg.tau_extra0), []
        for t in range(e):
            seen.append((snap, float(te)))
            step = r * e + t + 1
            inner = step % e
            sched = cfg.budget > 1 and inner % per == 0 and 0 < inner < e
            tau = one / max(np.float32(rates[r, t, pod]), tiny)
            if sched and not bool(outages[r, t, pod]) and tau <= te:
                snap, te = step, np.float32(te - tau)
        out.append(seen)
    return out


def opp_sync_rank(rank: int, world: int, device, full: bool) -> dict:
    """The rank body of phase 11a/b: this pod's rounds (one per entry of
    OPP_SCHEMES, each through ``make_opp_sync_round``) on Llama-3.2-1B cut
    to OPP_LAYERS layers (``full``) or reduced at f32, from one param tree
    and one trace.  Returns per round the losses, the snapshot slots at
    each step's entry, whether the pods' params are bitwise equal and the
    slots reset, and its host-clock spans: the round, its train steps
    (each between two synchronizes), the wait for the other pods after
    the last step (a barrier) and the rest, which is the last
    ``maybe_snapshot`` and ``round_sync``; then the peak memory, the
    launches and the backend (and the params per round when reduced)."""
    from dataclasses import replace
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.opportunistic_sync import (OppSyncConfig,
                                                     make_opp_sync_round)
    from repro_torch.data import make_token_stream
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.2-1b")
    cfg = cfg.replace(num_layers=OPP_LAYERS) if full else cfg.reduced()
    seq = OPP_S if full else OPP_REDUCED_S
    model = build_model(cfg, device)
    gen = torch.Generator(device if full else "cpu").manual_seed(0)
    params = model.init(gen)
    for leaf in tree_leaves(params):      # one starting point for all pods
        dist.broadcast(leaf, src=0)
    opt = sgd(OPP_LR)
    base = OppSyncConfig(**OPP_CFG)
    state = create_train_state(params, opt, with_opt_sync=True,
                               tau_extra0=base.tau_extra0)
    del params
    step, seen, marks = make_train_step(model, opt), [], []
    e, n = base.inner_steps, len(OPP_SCHEMES)

    def wait():
        if on_card:
            torch.cuda.synchronize()

    def recorded(st, batch):
        seen.append((st.snapshot_step.clone(), st.tau_extra.clone()))
        wait()
        t = time.perf_counter()
        out = step(st, batch)
        wait()
        marks.append((t, time.perf_counter()))
        if len(marks) == e:               # every pod done with its steps
            dist.barrier()
            marks.append((time.perf_counter(),) * 2)
        return out

    ds = make_token_stream(world * e * OPP_B * n, seq,
                           vocab=cfg.vocab_size, seed=0)
    rates, outages, arrived = opp_trace()

    def pod_batches(r):
        lo = r * world * e * OPP_B
        return {k: torch.tensor(a[lo:lo + world * e * OPP_B].reshape(
            world, e, OPP_B, seq)[rank], device=device)
            for k, a in (("tokens", ds.x), ("labels", ds.y))}

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    rounds = []
    for r, scheme in enumerate(OPP_SCHEMES):
        one_round = make_opp_sync_round(replace(base, scheme=scheme),
                                        recorded)
        batches = pod_batches(r)
        seen.clear()
        marks.clear()
        dist.barrier()
        wait()
        t0 = time.perf_counter()
        state, losses = one_round(state, batches, rates[r], outages[r],
                                  arrived[r])
        wait()
        t1 = time.perf_counter()
        same = True
        for leaf in tree_leaves(state.params):
            ref = leaf.clone()
            dist.broadcast(ref, src=0)
            same = same and torch.equal(ref, leaf)
        rounds.append({
            "scheme": scheme, "ms": (t1 - t0) * 1e3,
            "steps_ms": sum(b - a for a, b in marks[:e]) * 1e3,
            "wait_ms": (marks[e][0] - marks[e - 1][1]) * 1e3,
            "sync_ms": (t1 - marks[e][0]) * 1e3,
            "losses": losses.cpu(),
            "seen": [(int(a), float(b)) for a, b in seen],
            "bitwise_pods": same,
            "reset": (int(state.snapshot_step) == -1
                      and float(state.tau_extra) == base.tau_extra0),
            "arrived": arrived[r].tolist(),
            "params": None if full else [t.cpu() for t in
                                         tree_leaves(state.params)]})
    launches = all_launches()
    return {"rounds": rounds, "launches": launches,
            "peak_gib": gb(torch.cuda.max_memory_allocated())
            if on_card else None,
            "backend": dist.get_backend(), "device": str(device),
            "n_params": sum(t.numel() for t in tree_leaves(state.params))}


def sharded_sweep_rank(rank: int, world: int, device) -> dict:
    """The rank body of phase 11c: phase 9's Fig. 3(b) panel through
    ``Experiment.run`` on the sweep's group, counts set to 0 just before
    and read just after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.utils.tree import tree_map
    ex = sweep_panels()[0][1]
    group = make_sweep_mesh()
    reset_all_launches()
    res = ex.run(engine="sweep", mesh=group)
    launches = all_launches()
    for g in res.groups:
        g.final_params = tree_map(lambda t: t.cpu(), g.final_params)
    return {"res": res, "launches": launches,
            "backend": dist.get_backend(group), "device": str(device)}


def check_opp_sync(out: list, full: bool) -> None:
    """Phase 11a's checks over every rank's result."""
    rates, outages, _ = opp_trace()
    tag = f"llama3.2-1b {OPP_LAYERS} of 16 layers" if full else "reduced"
    for rank, o in enumerate(out):
        want = host_decisions(rates.numpy(), outages.numpy(), rank)
        for r, rd in enumerate(o["rounds"]):
            if not rd["bitwise_pods"]:
                raise AssertionError(f"{tag} round {r}: pod {rank}'s params "
                                     "differ from pod 0's")
            if not rd["reset"]:
                raise AssertionError(f"{tag} round {r}: pod {rank}'s "
                                     "snapshot slots were not reset")
            if rd["seen"] != want[r]:
                raise AssertionError(
                    f"{tag} round {r}: pod {rank}'s decisions {rd['seen']} "
                    f"differ from the trace's {want[r]}")
            if not bool(np.isfinite(rd["losses"].numpy()).all()):
                raise AssertionError(f"{tag} round {r}: pod {rank}'s losses "
                                     f"{rd['losses']} are not finite")
        if any(o["launches"][n] for n in ZOO + MOE):
            raise AssertionError(f"{tag}: pod {rank} launched a zoo kernel "
                                 f"{ {n: o['launches'][n] for n in ZOO + MOE} }")


def opp_sync_path() -> dict:
    """(11a) OpportunisticSync with OPP_PODS ranks on the card at full
    width, then the same ranks at the reduced size; (11b) the reduced
    rounds on OPP_PODS CPU ranks against the card's."""
    from repro_torch.launch.mesh import spawn_ranks
    card = spawn_ranks(opp_sync_rank, OPP_PODS, None, args=(True,),
                       tmpdir=RANKS_DIR, timeout_s=OPP_TIMEOUT_S)
    check_opp_sync(card, full=True)
    snaps = sum(len({s[0] for s in rd["seen"] if s[0] >= 0})
                for o in card for rd in o["rounds"])
    span = {k: np.array([[rd[k] for rd in o["rounds"]] for o in card])
            for k in ("ms", "steps_ms", "wait_ms", "sync_ms")}
    share = span["sync_ms"] / span["ms"]
    loss = np.array([[float(rd["losses"].mean()) for rd in o["rounds"]]
                     for o in card]).mean(0)
    for r, scheme in enumerate(OPP_SCHEMES):
        print(f"  round {r + 1} ({scheme}), ms per rank: round "
              f"{span['ms'][:, r].round(1).tolist()}, train steps "
              f"{span['steps_ms'][:, r].round(1).tolist()}, wait for the "
              f"other pods {span['wait_ms'][:, r].round(1).tolist()}, last "
              f"maybe_snapshot + round_sync "
              f"{span['sync_ms'][:, r].round(1).tolist()} (share of the "
              f"round {share[:, r].round(3).tolist()}); mean inner loss "
              f"{loss[r]:.4f}, arrived {card[0]['rounds'][r]['arrived']}")
    print(f"  {OPP_PODS} ranks on {card[0]['device'].split(':')[0]} "
          f"({', '.join(o['device'] for o in card)}), backend "
          f"{card[0]['backend']}; {card[0]['n_params']} params a pod "
          f"({gb(4 * card[0]['n_params']):.2f} GiB f32), the card "
          f"synchronized around every train step; peak GiB per rank {[round(o['peak_gib'], 2) for o in card]}; "
          f"pods bitwise equal after every round, slots reset, decisions "
          f"equal the trace's ({snaps} snapshots taken), losses finite, "
          f"zoo launches 0 on every rank")
    print(card_line())
    reduced = {}
    for key, dev in (("card", None), ("cpu", "cpu")):
        reduced[key] = spawn_ranks(opp_sync_rank, OPP_PODS, dev,
                                   args=(False,), tmpdir=RANKS_DIR,
                                   timeout_s=OPP_TIMEOUT_S)
        check_opp_sync(reduced[key], full=False)
    lerr = perr = 0.0
    for g, c in zip(reduced["card"], reduced["cpu"]):
        for rg, rc in zip(g["rounds"], c["rounds"]):
            if rg["seen"] != rc["seen"] or rg["arrived"] != rc["arrived"]:
                raise AssertionError("card and CPU decisions differ")
            lerr = max(lerr, float(((rg["losses"] - rc["losses"]).abs()
                                    / rc["losses"].abs()).max()))
            scale = max(float(t.abs().max()) for t in rc["params"])
            perr = max(perr, max(float((a - b).abs().max()) for a, b in
                                 zip(rg["params"], rc["params"])) / scale)
    ok = lerr <= OPP_LOSS_RTOL and perr <= OPP_PARAM_RTOL
    print(f"  reduced f32, {len(OPP_SCHEMES)} rounds on {OPP_PODS} ranks, "
          f"card ({reduced['card'][0]['backend']}) vs CPU "
          f"({reduced['cpu'][0]['backend']}): decisions and arrivals equal, "
          f"loss within {lerr:.2e} (tol {OPP_LOSS_RTOL:.0e}), params within "
          f"{perr:.2e} of the largest (tol {OPP_PARAM_RTOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("OpportunisticSync: card and CPU disagree")
    return {"launches": {n: sum(o["launches"][n] for o in card)
                         for n in ZOO + MOE},
            "round_ms": float(np.median(span["ms"])),
            "sync_ms": float(np.median(span["sync_ms"])),
            "sync_share": float(np.median(share))}


def sharded_sweep_path(fig3b, per_row_ms: dict) -> list:
    """(11c) phase 9's Fig. 3(b) panel over SWEEP_RANKS ranks on the card:
    each rank's launches equal the panel's, every gathered row equals
    phase 9's bit for bit.  Returns each rank's launches."""
    import torch
    from repro_torch.core.sweep import compile_spec
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.utils.tree import tree_leaves
    groups = compile_spec(sweep_panels()[0][1].to_spec())
    want = expected_sweep_launches(groups, SWEEP_ROUNDS)
    out = spawn_ranks(sharded_sweep_rank, SWEEP_RANKS, None,
                      tmpdir=RANKS_DIR, timeout_s=OPP_TIMEOUT_S)
    for rank, o in enumerate(out):
        if o["launches"] != want:
            raise AssertionError(f"sharded sweep rank {rank}: launches "
                                 f"{o['launches']} != expected {want}")
        for g, w in zip(o["res"].groups, fig3b.groups):
            same = all(np.array_equal(g.metrics[k], w.metrics[k])
                       for k in w.metrics) and all(
                torch.equal(a, b.cpu()) for a, b in zip(
                    tree_leaves(g.final_params),
                    tree_leaves(w.final_params)))
            if not same:
                raise AssertionError(f"sharded sweep rank {rank}: "
                                     f"{g.label}'s rows differ from phase 9")
    rows = {g.label: len(g.sims) * len(g.cfgs) // SWEEP_RANKS
            for g in fig3b.groups}
    print(f"  fig3b on {SWEEP_RANKS} ranks ({out[0]['backend']}, "
          f"{', '.join(o['device'] for o in out)}): launches per rank as "
          f"expected { {n: c for n, c in want.items() if c} }; every "
          f"gathered row (counts, bytes, test loss and accuracy, final "
          f"params) bitwise phase 9's; ms per simulated round per row, per "
          f"rank: "
          + ", ".join(f"{g.label} {[round(o['res'].groups[i].run_s * 1e3 / SWEEP_ROUNDS / rows[g.label], 2) for o in out]} (phase 9 {per_row_ms[g.label]:.2f})"  # noqa: E501
                      for i, g in enumerate(fig3b.groups)))
    return [o["launches"] for o in out]


def run_multipod_example() -> float:
    """(11d) the multipod twin as a subprocess on the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.opportunistic_multipod",
         "--rounds", "2"], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=300)
    secs = time.perf_counter() - t0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    print(f"  examples/opportunistic_multipod --rounds 2: exit "
          f"{proc.returncode} in {secs:.1f} s; last line: {last}")
    if proc.returncode != 0 or "OpportunisticSync OK" not in last:
        raise AssertionError(f"the multipod twin failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return secs


def ranks_path(fig3b, per_row_ms: dict):
    """Phase 11; returns (the zoo and moe kernels' launches summed over the
    OpportunisticSync ranks, which must be 0, each sweep rank's launches,
    the OpportunisticSync numbers)."""
    import torch
    t0 = time.perf_counter()
    os.makedirs(RANKS_DIR, exist_ok=True)
    torch.cuda.empty_cache()              # phase 10 leaves its cache
    print(f"  parent holds {gb(torch.cuda.memory_allocated()):.2f} GiB on "
          f"the card before spawning")
    numbers = opp_sync_path()
    t1 = time.perf_counter()
    print(f"  11a-b wall time {t1 - t0:.1f} s")
    sweep_launches = sharded_sweep_path(fig3b, per_row_ms)
    print(f"  11c wall time {time.perf_counter() - t1:.1f} s")
    numbers["example_s"] = run_multipod_example()
    print(f"  ranks phase wall time {time.perf_counter() - t0:.1f} s")
    return numbers.pop("launches"), sweep_launches, numbers


# ---------------------------------------------------------------------------
# phase 12: the dry run on the card machine
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "llama3.2-1b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# 12b: the dry run's peak against the card's max_memory_allocated
PEAK_BAND = (0.8, 1.25)


def dryrun_record(shape: str, multi_pod: bool, device: str) -> dict:
    """One (arch, shape, mesh) of 12a in a process of its own: a fake world
    of 256 or 512 ranks with fake tensors on ``device``.  Adds the card
    memory the process allocated (it must be none)."""
    import torch
    from repro_torch.launch.dryrun import run_one
    if torch.device(device).type == "cuda":
        # FakeTensorMode's own first step on a device: one real
        # one-element tensor, freed at once, per device spelling
        from torch._subclasses.fake_tensor import init_gpu_context
        for dev in (torch.device("cuda"), torch.device("cuda", 0)):
            init_gpu_context(dev)
        torch.cuda.reset_peak_memory_stats()
    rec = run_one(DRYRUN_ARCH, shape, multi_pod, device=device,
                  verbose=False)
    rec["card_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.cuda.is_initialized() else 0)
    return rec


def check_dryrun_records(recs: list) -> None:
    """(12a) The six records of ``dryrun_record``: each ok, on its world's
    ranks, with argument bytes, calibrated FLOPs equal to the full
    program's and no card memory; printed with their seconds, bytes per
    device and roofline terms.  Then hubert-xlarge x long_500k, a
    documented skip."""
    import torch
    from repro_torch.launch.dryrun import run_one
    hbm = torch.cuda.get_device_properties(0).total_memory
    bad = [r for r in recs if r["status"] != "ok"]
    for rec in bad:
        print(f"  dry run {rec['arch']} x {rec['shape']} multi_pod="
              f"{rec['multi_pod']} FAILED: {rec.get('error')}\n"
              f"{rec.get('traceback', '')}")
    if bad:
        raise AssertionError(f"{len(bad)} of {len(recs)} dry-run programs "
                             f"failed")
    for rec in recs:
        want = 512 if rec["multi_pod"] else 256
        r = rec["roofline"]
        ok = (rec["n_chips"] == want and rec["card_bytes"] == 0
              and rec["memory"]["argument_size_in_bytes"] > 0
              and rec["hlo_flops_per_device"] == rec["full_depth"]["flops"])
        print(f"  {rec['arch']} x {rec['shape']} on "
              f"{'2x16x16' if rec['multi_pod'] else '16x16'} "
              f"({rec['n_chips']} fake ranks, {rec['device']}): "
              f"{rec['total_compile_s']:.1f} s; bytes per device "
              f"{gb(rec['bytes_per_device']):.2f} GiB of the card's "
              f"{gb(hbm):.1f} (argument {gb(rec['memory']['argument_size_in_bytes']):.2f}); "
              f"FLOPs per device {rec['hlo_flops_per_device']:.4e} "
              f"(calibrated = full depth: "
              f"{rec['hlo_flops_per_device'] == rec['full_depth']['flops']}), "
              f"HBM bytes {rec['hlo_bytes_per_device']:.4e}, collective "
              f"bytes {rec['coll_bytes_per_device']:.4e}; roofline at the "
              f"H100 datasheet's rates: compute {r['compute_s'] * 1e3:.3f} "
              f"ms, memory {r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}, "
              f"useful ratio {r['useful_ratio']:.3f}; card memory used "
              f"{rec['card_bytes']} B {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dry run record {rec['shape']} "
                                 f"multi_pod={rec['multi_pod']} is wrong")
    skip = run_one("hubert-xlarge", "long_500k", False, device=DEVICE,
                   verbose=False)
    if skip["status"] != "skip_documented":
        raise AssertionError(f"hubert-xlarge x long_500k: {skip}")
    print(f"  hubert-xlarge x long_500k: {skip['status']} (encoder-only: "
          f"no decode)")


def dryrun_vs_card() -> dict:
    """(12b) The dry run against one real step: phase 10's Llama-3.2-1B
    train step (B=TRAIN_B x S=TRAIN_S, AdamW, clip 1.0, bf16 compute on
    f32 params, remat none) predicted on a fake one-rank world's (1, 1)
    ``("data", "model")`` mesh, then run on the card under the same
    counter (``utils.op_stats.ProgramStats``) with
    ``max_memory_allocated`` after a reset: FLOPs equal, the predicted
    peak within PEAK_BAND of the measured one."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import (DRYRUN_LR, make_opts, measure,
                                           roofline_terms)
    from repro_torch.launch.mesh import PRODUCTION_AXES, fake_world, make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.utils.op_stats import ProgramStats
    cfg = get_config(DRYRUN_ARCH)
    shape = InputShape("phase10", TRAIN_S, TRAIN_B, "train")
    opts = make_opts("train", False, remat="none")
    with fake_world(1):
        mesh = make_mesh((1, 1), PRODUCTION_AXES, DEVICE)
        pred = measure(cfg, shape, mesh, False, opts, DEVICE)
    model = build_model(cfg, DEVICE)
    opt = adamw(DRYRUN_LR)
    state = create_train_state(
        model.init(torch.Generator(DEVICE).manual_seed(0)), opt)
    batch = token_batch(cfg, TRAIN_B, TRAIN_S)
    step = make_train_step(model, opt, grad_clip=1.0)
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with ProgramStats(hold=(state, batch)) as counter:
        new, met = step(state, batch)
        counter.outputs((new, met))
    sync()
    peak = torch.cuda.max_memory_allocated()
    real = counter.record()
    del new, met
    times = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        out = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    # what the card held beyond the step's arguments before it began
    other = base - real["memory"]["argument_size_in_bytes"]
    measured = peak - other
    ratio = pred["memory"]["peak_memory_in_bytes"] / measured
    terms = roofline_terms(cfg, shape, pred["flops"], pred["bytes"],
                           pred["coll_bytes"], 1)
    top = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    ok = (pred["flops"] == real["flops"]
          and PEAK_BAND[0] <= ratio <= PEAK_BAND[1])
    print(f"  {DRYRUN_ARCH} train step B={TRAIN_B} x S={TRAIN_S} (AdamW, "
          f"clip 1.0, remat none), fake one-rank (1, 1) mesh vs the card: "
          f"FLOPs {pred['flops']:.6e} predicted, {real['flops']:.6e} "
          f"counted on the card (equal: {pred['flops'] == real['flops']}); "
          f"argument bytes {gb(pred['memory']['argument_size_in_bytes']):.3f}"
          f" GiB predicted, {gb(real['memory']['argument_size_in_bytes']):.3f}"
          f" on the card; peak {gb(pred['memory']['peak_memory_in_bytes']):.3f}"
          f" GiB predicted, the counter's on the card "
          f"{gb(real['memory']['peak_memory_in_bytes']):.3f}, "
          f"max_memory_allocated {gb(peak):.3f} less {gb(other):.3f} held "
          f"before = {gb(measured):.3f} (predicted / measured {ratio:.4f}, "
          f"band {PEAK_BAND}); HBM bytes predicted {pred['bytes']:.4e} "
          f"(the card's count {real['bytes']:.4e}); the fake run "
          f"{pred['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
    print(f"  the step on the card {times[-1]:.1f} ms (first {times[0]:.1f})"
          f" against the roofline's largest term {top * 1e3:.3f} ms "
          f"({max(('compute_s', 'memory_s', 'collective_s'), key=terms.get)}"
          f"; compute {terms['compute_s'] * 1e3:.3f}, memory "
          f"{terms['memory_s'] * 1e3:.3f} ms at the H100 datasheet's rates)"
          f": {times[-1] / (top * 1e3):.2f}x")
    if not ok:
        raise AssertionError("the dry run's prediction misses the card's "
                             "step")
    del state, batch
    torch.cuda.empty_cache()
    return {"pred": pred, "real": real, "peak": peak, "measured": measured,
            "ratio": ratio, "ms": times[-1], "bound_ms": top * 1e3}


def dryrun_path() -> dict:
    """Phase 12: (12a) ``run_one`` for Llama-3.2-1B x train_4k,
    prefill_32k and decode_32k on the 16 x 16 and 2 x 16 x 16 meshes, with
    calibration, each in a spawned process (six at once), while this
    process runs (12b)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    cells = [(s, mp_) for mp_ in (False, True) for s in DRYRUN_SHAPES]
    with ProcessPoolExecutor(len(cells),
                             mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(dryrun_record, s, mp_, DEVICE)
                for s, mp_ in cells]
        vs = dryrun_vs_card()
        recs = [f.result() for f in futs]
    check_dryrun_records(recs)
    return {"records": recs, "vs_card": vs}


# ---------------------------------------------------------------------------
# phase 13: the analysis on the card (lint, contracts, runtime guards)
# ---------------------------------------------------------------------------

# memory_budget's check: the fused opt round passes at its peak plus this
PEAK_SLACK = 2 ** 20


# processes of the IR sweep (13a), which runs beside phases 12 and 13
IR_JOBS = 6


def start_analysis_cli(*flags: str):
    """(13a) ``python -m repro_torch.analysis`` as a subprocess with no
    ``--device``; ``finish_analysis_cli`` waits for it.  Two are started:
    the lint and the contracts on the card (the twins' kernel sides
    launch), beside 13b-d; and, with phase 12, the IR sweep (``--ir
    --no-lint --no-contracts``: the graph walk, the bf16 audit and the
    K-scaling gate against the committed record, every registry program
    traced on the CPU through the twins in ``IR_JOBS`` processes), which
    needs no card and runs on the cores the dry run leaves."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", *flags],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True), time.perf_counter(), \
        " ".join(flags)


def stop_analysis_cli(started) -> None:
    """Kill a CLI still running (a phase failed first), its sweep's
    worker processes with it (their own session)."""
    import signal
    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_analysis_cli(started) -> float:
    proc, t0, flags = started
    out, err = proc.communicate(timeout=900)
    secs = time.perf_counter() - t0
    print(f"  (13a) python -m repro_torch.analysis {flags}: exit "
          f"{proc.returncode} after {secs:.1f} s: {out.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"repro_torch.analysis {flags} failed on the "
                             f"card's host:\n{out}\n{err[-4000:]}")
    return secs


def start_ir_sweep():
    return start_analysis_cli("--ir", "--no-lint", "--no-contracts",
                              "--jobs", str(IR_JOBS))


def guarded_groups() -> list:
    """(13b) Phase 9's Fig. 3(c) group and its codec group, each round loop
    under ``engine_guard(budget=<the group's expected launches>)`` and the
    device-to-host guard: no transfer either way, launches equal to the
    budget, no ``torch.func`` leak, no library build."""
    from repro_torch.analysis.guards import engine_guard, no_implicit_transfers
    from repro_torch.core import sweep
    out = []
    for name, ex, _ in sweep_panels():
        if name == "fig3b":
            continue
        for group in sweep.compile_spec(ex.to_spec()):
            data = sweep._sim_tensors(sweep._stack_sims(group), DEVICE)
            carry, streams, cfg = sweep._group_inputs(group, data, DEVICE)
            fn = sweep.build_device_round(**sweep._group_build_kwargs(group))
            want = {n: c for n, c in expected_sweep_launches(
                [group], SWEEP_ROUNDS).items() if c}
            budget = sum(want.values())
            sync()
            t0 = time.perf_counter()
            with engine_guard(budget=budget) as lc:
                with no_implicit_transfers("device_to_host"):
                    carry, per_round = sweep._scan_rounds(
                        fn, carry, streams, data, cfg, SWEEP_ROUNDS)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            got = lc.launches()
            if got != want or lc.count() != budget or lc.builds:
                raise AssertionError(f"guarded {name}/{group.label}: "
                                     f"launches {got} != {want} or builds "
                                     f"{lc.builds}")
            m = sweep._read_metrics(per_round, len(group.sims),
                                    len(group.cfgs))
            if not np.all(np.isfinite(m["test_loss"])):
                raise AssertionError(f"guarded {name}/{group.label}: "
                                     "non-finite loss")
            # the same loop unguarded: what the guards cost while on
            carry0, streams0, cfg0 = sweep._group_inputs(group, data, DEVICE)
            sync()
            t0 = time.perf_counter()
            sweep._scan_rounds(fn, carry0, streams0, data, cfg0,
                               SWEEP_ROUNDS)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            rows = len(group.sims) * len(group.cfgs)
            print(f"  (13b) {name}/{group.label} (G={rows}): "
                  f"{SWEEP_ROUNDS} rounds under engine_guard(budget="
                  f"{budget}) and the device-to-host guard in {ms:.1f} ms "
                  f"({plain_ms:.1f} ms unguarded): launches equal the "
                  f"budget {want}, no implicit transfer, no torch.func "
                  f"leak, 0 library builds")
            out.append((group, fn, carry, streams, data, cfg, want))
    return out


def guards_bite(groups) -> dict:
    """(13c) Each guard raises on its violation on the card; returns the
    fused opt round's peak bytes, and the round's function and its inputs
    copied to the host (for 13d)."""
    import torch
    from repro_torch.analysis.guards import (ImplicitTransfer,
                                             LaunchBudgetExceeded,
                                             MemoryBudgetExceeded,
                                             engine_guard, memory_budget,
                                             no_implicit_transfers)
    from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation
    from repro_torch.kernels.delta_codec.kernel import quantize_blocks
    from repro_torch.utils.tree import tree_map

    def raises(exc, what, fn):
        try:
            fn()
        except exc as e:
            print(f"  (13c) {what}: raised {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:160]}")
            return
        raise AssertionError(f"{what}: the guard did not raise {exc}")

    group, fn, carry, streams, data, cfg, want = groups[0]
    carry, m = fn(carry, SWEEP_ROUNDS + 1, streams, data, cfg)

    def read_in_guard():
        with no_implicit_transfers("all"):
            m.test_acc[0].item()

    def copy_in_guard():
        with engine_guard():
            torch.ones(4).cuda()

    one = {n: c // SWEEP_ROUNDS for n, c in want.items()}
    spare = torch.zeros((4, 512), device=DEVICE)

    def extra_launch():
        with engine_guard(budget=sum(one.values())):
            fn(carry, SWEEP_ROUNDS + 2, streams, data, cfg)
            quantize_blocks(spare)

    raises(RuntimeError, ".item() of a round output under "
           "no_implicit_transfers('all')", read_in_guard)
    raises(ImplicitTransfer, "torch.ones(4).cuda() under engine_guard()",
           copy_in_guard)
    raises(LaunchBudgetExceeded, f"one round of {group.label} plus one "
           f"quantize_blocks under a budget of the round's "
           f"{sum(one.values())} launches", extra_launch)

    # memory_budget around the fused opt round at the paper's configuration:
    # round 2 of three copies of one simulation, so that each runs the same
    # round (K, the schedule) from the same state
    sim = HSFLSimulation(HSFLConfig(rounds=2, scheme="opt", b=2))
    sim.run_round(1, [])                          # warm-up
    sims = [copy.deepcopy(sim) for _ in range(3)]
    fused, seen = sims[0]._fused, {}

    def capture(*args):
        # the round's inputs on the host, for the walker (13d): a copy to
        # the host allocates nothing on the card
        seen["args"] = tuple(tree_map(lambda t: t.cpu(), a) for a in args)
        return fused(*args)

    sims[0]._fused = capture
    with memory_budget(2 ** 40) as rec:
        sims[0].run_round(2, [])
    (label, peak), = rec
    with memory_budget(peak + PEAK_SLACK) as rec2:
        sims[1].run_round(2, [])

    def half_peak():
        with memory_budget(peak // 2):
            sims[2].run_round(2, [])

    raises(MemoryBudgetExceeded, f"the fused opt round under half its "
           f"{peak}-byte peak", half_peak)
    print(f"  (13c) fused opt round 2 (paper config): {label} {peak} bytes "
          f"({peak / 2**20:.2f} MiB); again {rec2[0][1]} bytes under a "
          f"budget of that peak + {PEAK_SLACK} bytes")
    return {"peak_bytes": peak, "fused": fused, "args": seen["args"]}


def walker_vs_card(fused, args, card_peak: int) -> dict:
    """(13d) The IR walker's peak of the same fused opt round (round 2,
    paper config), traced on the CPU from the card run's own inputs
    through the twins, beside the card's ``max_memory_allocated`` over
    the round (13c).  No bound: the walker counts every buffer the twins'
    plain torch asks for, each freed at its last use; the card, the
    kernels' and the caching allocator's."""
    from repro_torch.analysis.ir.graph_audit import audit_graph, trace_fn
    t0 = time.perf_counter()
    audit = audit_graph("fused_round[opt]", trace_fn(fused, args))
    secs = time.perf_counter() - t0
    k = args[1].shape[1]
    top = ", ".join(f"{b.site.label()} {b.nbytes}"
                    for b in audit.top_buffers(4))
    print(f"  (13d) walker peak of fused_round[opt] (paper config, the "
          f"round's K bucket {k}, {audit.n_eqns} aten ops, traced in "
          f"{secs:.1f} s): {audit.peak_bytes} bytes vs the card's "
          f"{card_peak} bytes: ratio walker/card "
          f"{audit.peak_bytes / card_peak:.4f}; largest at the peak: {top}")
    return {"walker_peak_bytes": audit.peak_bytes, "k": k,
            "ratio": audit.peak_bytes / card_peak}


def analysis_path(ir_sweep) -> dict:
    """Phase 13: (a) the CLI in a subprocess while this process runs (b),
    (c) and (d); then the IR sweep's subprocess, started with phase 12."""
    t0 = time.perf_counter()
    started = start_analysis_cli("--strict-baseline")
    try:
        groups = guarded_groups()
        numbers = guards_bite(groups)
        numbers.update(walker_vs_card(numbers.pop("fused"),
                                      numbers.pop("args"),
                                      numbers["peak_bytes"]))
        numbers["cli_s"] = finish_analysis_cli(started)
    finally:
        stop_analysis_cli(started)
    numbers["ir_s"] = finish_analysis_cli(ir_sweep)
    numbers["wall_s"] = time.perf_counter() - t0
    print(f"  analysis phase wall time {numbers['wall_s']:.1f} s")
    return numbers


class PhaseClock:
    """Wall time of each phase: ``start`` ends the running phase, printing
    its seconds, and begins the next; ``summary`` is every phase's seconds
    and the script's total since the clock was made."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.walls = {}
        self._running = None

    def start(self, n: int, title: str) -> None:
        self.stop()
        print(f"== phase {n}: {title}", flush=True)
        self._running = (n, time.perf_counter())

    def stop(self) -> None:
        if self._running is None:
            return
        n, t = self._running
        self.walls[n] = time.perf_counter() - t
        self._running = None
        print(f"  phase {n} wall time {self.walls[n]:.1f} s", flush=True)

    def summary(self) -> str:
        self.stop()
        return ("wall time by phase (s): "
                + ", ".join(f"{n} {w:.1f}" for n, w in self.walls.items())
                + f"; total {time.perf_counter() - self.t0:.1f} s")


def main() -> int:
    clock = PhaseClock()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    clock.start(1, "card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    clock.start(2, "build")
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

    clock.start(3, "kernels vs plain twins on the card")
    chk = Check()
    check_case(chk, "main path", 10, 10, seed=0)
    check_case(chk, "main path", 10, 10, seed=0, bf16=True)
    check_case(chk, "sweep group", 60, 10, seed=5)
    check_case(chk, "sweep group", 60, 10, seed=5, bf16=True)
    check_eval_group(chk)
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

    clock.start(4, "fused path (paper config, every scheme, codec)")
    launches, fused_ms = main_path()
    share = device_busy_share()

    clock.start(5, "policy path (paper config, bf16, single-user, "
          "im2col)")
    user_launches, launches_bf16, policy_ms = policy_path()
    launches.update({n: user_launches[n] for n in USER_CNN})
    share_bf16 = device_busy_share(precision="bf16")

    clock.start(6, "serving path (paper config, codec, faults, crash)")
    codec_launches, serve_ms = serving_path()
    launches.update(codec_launches)
    serve_round_ms, serve_share = serving_busy_share()

    clock.start(7, "card vs CPU")
    card_vs_cpu()

    clock.start(8, "zoo path (Llama-3.2-1B, RWKV6-7B cut to "
          f"{RWKV_LAYERS} layers: prefill, cache path, serving)")
    zoo_timing, zoo_launches, families = zoo_path(chk)
    timing.update(zoo_timing["bf16"])
    launches.update(zoo_launches)

    clock.start(9, "sweep path (paper config, 5 rounds: Fig. 3(b) "
          "panel, Fig. 3(c) budget axis, codec panel)")
    sweep_launches, sweep_numbers, sweep_results = sweep_path(fused_ms)

    clock.start(10, "zoo training (Llama-3.2-1B, B=2 x S=2048: steps, "
          "remat, fused head, resume, card vs CPU, the example twins)")
    train_launches, train_numbers = train_path()

    clock.start(11, f"ranks on the card ({OPP_PODS} OpportunisticSync "
          f"pods at Llama-3.2-1B full width, {OPP_LAYERS} of 16 layers; the "
          f"Fig. 3(b) sweep over {SWEEP_RANKS} ranks; the multipod twin)")
    opp_launches, ranks_sweep_launches, opp_numbers = ranks_path(
        sweep_results["fig3b"],
        {k.split("/", 1)[1]: v["per_row_ms"]
         for k, v in sweep_numbers.items() if k.startswith("fig3b/")})

    clock.start(12, f"the dry run ({DRYRUN_ARCH} on fake 256- and 512-rank "
                    f"worlds; its prediction of phase 10's step vs the card)")
    ir_sweep = start_ir_sweep()
    try:
        dryrun_path()
        clock.start(13, "analysis on the card (lint + contracts on cuda, "
                        "the guarded sweep groups, every guard bites, the IR "
                        "walker vs the card, the IR sweep begun with phase "
                        "12)")
        analysis_path(ir_sweep)
    finally:
        stop_analysis_cli(ir_sweep)

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
            # phase 10's training steps go through the einsum paths
            row["train_launches"] = train_launches[n]
            # phase 11's OpportunisticSync ranks train the same way
            row["opp_sync_launches"] = opp_launches[n]
            if n == "flash_attention_bh":
                # one launch a layer in each family's prefill
                row["family_launches"] = {a: f["launches"]
                                          for a, f in families.items()}
        if n in FUSED_CNN + CODEC:
            # the sweep path's three panels (15 group rounds in all)
            row["sweep_launches"] = sweep_launches[n]
            # phase 11: the Fig. 3(b) panel over ranks, each rank's count
            row["sharded_sweep_launches"] = [la[n]
                                             for la in ranks_sweep_launches]
        if n in timing_bf16:
            tb = timing_bf16[n]
            row.update(bf16_launches=launches_bf16[n], bf16_ms=tb["ms"],
                       bf16_plain_ms=tb["plain_ms"],
                       bf16_bound_ms=tb["bound_ms"],
                       bf16_bitwise_share=chk.bf16_equal.get(n))
        rows.append(row)
    moe_timing = zoo_timing["moe"]["timing"]
    for n in MOE:
        t = moe_timing[n]
        rows.append({
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": None, "launches": launches[n],
            "launches_per_call": LAUNCHES_PER_CALL[n],
            "max_abs_err": zoo_timing["moe"]["max_abs_err"][n],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "dtype": "bfloat16",
            # one call of each wrapper a layer in granite's prefill
            "family_launches": {a: f["moe_launches"][n]
                                for a, f in families.items()},
            "train_launches": train_launches[n],
            "opp_sync_launches": opp_launches[n],
            "sweep_launches": sweep_launches[n],
            "sharded_sweep_launches": [la[n]
                                       for la in ranks_sweep_launches]})
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
    busy = {k: "not measured" if v["busy"] is None else f"{v['busy']:.4f}"
            for k, v in sweep_numbers.items()}
    print("sweep groups (paper config), ms per simulated round per (sim, "
          "config) and busy share: "
          + ", ".join(f"{k} {v['per_row_ms']:.2f} ms x{v['rows']} busy "
                      f"{busy[k]}" for k, v in sweep_numbers.items())
          + f"; fused opt round {fused_ms:.1f} ms")
    print(f"llama3.2-1b training (B={TRAIN_B} x S={TRAIN_S}, bf16 compute, "
          f"f32 params, AdamW): {train_numbers['ms']:.1f} ms per step, "
          f"{train_numbers['tokens_per_s']:.0f} tokens/s, peak "
          f"{train_numbers['peak_gib']:.2f} GiB, device busy share "
          + ("not measured" if train_numbers["busy"] is None
             else f"{train_numbers['busy']:.4f}")
          + "; loss + grads peak GiB by remat: "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      train_numbers["remat_peak_gib"].items()))
    print(f"opportunistic sync ({OPP_PODS} pods on one card, Llama-3.2-1B "
          f"{OPP_LAYERS} of 16 layers, B={OPP_B} x S={OPP_S}, e="
          f"{OPP_CFG['inner_steps']}): median {opp_numbers['round_ms']:.1f} "
          f"ms a round per rank, its last maybe_snapshot + round_sync "
          f"{opp_numbers['sync_ms']:.1f} ms (median share of a round "
          f"{opp_numbers['sync_share']:.3f}); multipod twin "
          f"{opp_numbers['example_s']:.1f} s")
    print(card_line())
    print(json.dumps({"moe_dispatch_kernels": zoo_timing["moe"]}))
    print(json.dumps({"kernels": rows}))
    print(clock.summary())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
