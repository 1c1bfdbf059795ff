"""The general generator of zoo prefill traffic: a closed loop of batches
through the port's ``training.step.make_prefill_step`` of
``models.registry.build_model(cfg)``.

The traffic file gives ``tokens_per_batch`` and the sequence lengths:
lognormal (``seq.median``, ``seq.sigma``) rounded to a multiple of
``seq.multiple`` and clipped to [``seq.min``, ``seq.max``].  One cycle of
``cycle`` batches holds each length as often as its probability says
(largest remainders, the same for every seed); the seed orders the cycle
and draws the tokens.  Batch i has length S and B = tokens_per_batch // S
sequences; the loop runs cycle after cycle until ``--seconds`` have
passed, each batch timed from its submission to its logits being ready
(a synchronize).

The configuration file is the model as run, under its published keys;
the driver builds the port's ``ModelConfig`` from it and refuses a file
that asks for what the port does not do (the Granite multipliers, a
capacity factor other than the port's).  The weights are the
benchmark's (``inputs.zoo_weights``), in the layout of the port's
``registry.abstract_init``.

The check runs the configuration's reference on ``check_batches`` batches
of the first cycle drawn from the seed, the longest among them, and
compares the logits the timed path returned, position by position.
"""
from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import torch

from perfbench import inputs
from perfbench.harness import Check


def seq_cycle(t: Dict) -> List[int]:
    """The sequence lengths of one cycle, longest first (unordered)."""
    q = t["seq"]
    med, sig, lo, hi, mult = (q["median"], q["sigma"], q["min"], q["max"],
                              q["multiple"])
    cdf = lambda x: 0.5 * (1.0 + math.erf(  # noqa: E731
        (math.log(x) - math.log(med)) / (sig * math.sqrt(2.0))))
    sizes = list(range(lo, hi + 1, mult))
    p = {s: (1.0 if s == hi else cdf(s + mult / 2))
         - (0.0 if s == lo else cdf(s - mult / 2)) for s in sizes}
    n = int(t["cycle"])
    raw = {s: p[s] * n for s in sizes}
    cnt = {s: int(raw[s]) for s in sizes}
    for s in sorted(sizes, key=lambda s: cnt[s] - raw[s])[:n - sum(
            cnt.values())]:
        cnt[s] += 1
    return [s for s in sorted(sizes, reverse=True) for _ in range(cnt[s])]


def model_config(c: Dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    want = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
            "logits_scaling": 1.0,
            "attention_multiplier": (c["hidden_size"]
                                     // c["num_attention_heads"]) ** -0.5,
            "capacity_factor": moe.CAPACITY_FACTOR, "param_dtype": "float32",
            "torch_dtype": "bfloat16"}
    bad = {k: (c.get(k), v) for k, v in want.items() if c.get(k) != v}
    if bad:
        raise ValueError(f"{c['name']}: the port runs {want}; the file asks "
                         f"for {bad}")
    return ModelConfig(
        name=c["name"], family=c["family"],
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"], moe_d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], num_experts=c["num_local_experts"],
        experts_per_token=c["num_experts_per_tok"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], dtype="bfloat16",
        param_dtype="float32")


def weight_leaves(meta: Dict, prefix: str = "") -> list:
    """(path, shape, init) of every leaf of a meta params tree: norm
    scales 1, the embedding and the router normal(0, 0.02), every other
    matrix normal(0, fan_in^-1/2) with fan_in its second-to-last size."""
    out = []
    for k in sorted(meta):
        path = f"{prefix}{k}"
        v = meta[k]
        if isinstance(v, dict):
            out += weight_leaves(v, path + ".")
        elif k == "scale":
            out.append((path, tuple(v.shape), ("ones",)))
        elif k in ("table", "router"):
            out.append((path, tuple(v.shape), ("normal", 0.02)))
        else:
            out.append((path, tuple(v.shape),
                        ("normal", v.shape[-2] ** -0.5)))
    return out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.attempted = self.failed = 0
        self.lat: List[float] = []
        self.batches: List = []
        self.kept: Dict[int, torch.Tensor] = {}
        self.flash_launches = 0

    def _flash_count(self) -> int:
        from repro_torch.kernels.flash_attention import kernel as fk
        return sum(fk.LAUNCHES.values())

    def setup(self) -> None:
        from repro_torch.models.registry import abstract_init, build_model
        from repro_torch.training.step import make_prefill_step
        dev = self.ctx.device
        mcfg = model_config(self.cfg)
        model = build_model(mcfg, dev)
        self.params = inputs.zoo_weights(
            self.ctx.seed, weight_leaves(abstract_init(mcfg)), dev)
        self.step = make_prefill_step(model)
        sizes = seq_cycle(self.traffic)
        random.Random(inputs.derive_seed(self.ctx.seed, "order")) \
            .shuffle(sizes)
        tpb = int(self.traffic["tokens_per_batch"])
        self.cycle = [(tpb // s, s) for s in sizes]
        self.tokens = [inputs.token_batch(self.ctx.seed, i, b, s,
                                          self.cfg["vocab_size"], dev)
                       for i, (b, s) in enumerate(self.cycle)]
        n = min(int(self.traffic["check_batches"]), len(self.cycle))
        rng = random.Random(inputs.derive_seed(self.ctx.seed, "check"))
        longest = max(range(len(self.cycle)), key=lambda i: self.cycle[i][1])
        rest = [i for i in range(len(self.cycle)) if i != longest]
        self.keep = {longest, *rng.sample(rest, n - 1)}
        for b, s in sorted(set(self.cycle)):        # every shape, once
            i = self.cycle.index((b, s))
            self.step(self.params, {"tokens": self.tokens[i]})
        if dev == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, tracer) -> None:
        cuda = self.ctx.device == "cuda"
        f0 = self._flash_count()
        t0 = time.perf_counter()
        i = 0
        while True:
            b, s = self.cycle[i % len(self.cycle)]
            with tracer.span("perfbench.batch"):
                ta = time.perf_counter()
                logits = self.step(self.params,
                                   {"tokens": self.tokens[i % len(self.cycle)]})
                if cuda:
                    torch.cuda.synchronize()
                tb = time.perf_counter()
            self.lat.append(tb - ta)
            self.batches.append((b, s))
            if i in self.keep:
                self.kept[i] = logits
            del logits
            i += 1
            if tb - t0 >= seconds:
                break
        self.attempted = len(self.batches)
        self.flash_launches = self._flash_count() - f0

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        lat = sorted(self.lat)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        tokens = sum(b * s for b, s in self.batches)
        return {"prefill_tokens_per_s": tokens / window_s,
                "prefill_p95_ms": 1e3 * p95}

    def counters(self) -> Dict:
        return {"batches": len(self.batches),
                "flash_launches": self.flash_launches}

    def work_record(self) -> Dict:
        w, pk = self.ctx.work, self.ctx.peaks
        return {"model_flops": sum(w.batch_flops(self.cfg, b, s)
                                   for b, s in self.batches),
                "flash_bound_s": (sum(w.flash_bound_s(self.cfg, b, s, pk)
                                      for b, s in self.batches)
                                  if pk else None),
                "flash_kernel": w.KERNEL,
                "peak_flops": pk.get("bf16_flops_per_s")}

    def release(self) -> None:
        """Run through the timed path any kept batch the window closed
        before (outside the window), then drop the program's step; the
        weights (the benchmark's) and the kept logits stay for the check."""
        for i in sorted(self.keep - set(self.kept)):
            self.kept[i] = self.step(self.params, {"tokens": self.tokens[i]})
        self.step = None
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------
    def compare(self, got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
        """Each position's relative L2 gap of the logits over the real
        vocabulary: |got - want| / |want|, (B·S,) f32."""
        v = want.shape[-1]
        got = got[..., :v].float().reshape(-1, v)
        want = want.reshape(-1, v)
        out = []
        for r in range(0, want.shape[0], 4096):
            d = torch.linalg.vector_norm(got[r:r + 4096] - want[r:r + 4096],
                                         dim=-1)
            out.append(d / torch.clamp_min(torch.linalg.vector_norm(
                want[r:r + 4096], dim=-1), 1e-30))
        return torch.cat(out)

    def gaps(self, precision: str = "f32", against=None) -> torch.Tensor:
        """The positions' gaps of the kept batches: the program's logits
        (or, with ``against``, the reference at ``against``) vs the
        reference at ``precision``."""
        out = []
        for i, got in sorted(self.kept.items()):
            tok = self.tokens[i % len(self.cycle)]
            want = self.ctx.reference.prefill_logits(self.cfg, self.params,
                                                     tok, precision)
            if against is not None:
                got = self.ctx.reference.prefill_logits(self.cfg, self.params,
                                                        tok, against)
            out.append(self.compare(got, want))
            del want
        return torch.cat(out)

    def check(self) -> List[Check]:
        limits = self.traffic["limits"][self.ctx.cell["config"]]
        g = self.gaps()
        g = torch.where(torch.isnan(g), torch.inf, g)
        vals = {"logits_rel_median": float(torch.median(g)),
                "logits_rel_max": float(torch.max(g))}
        return [Check(k, vals[k], float(limits[k])) for k in limits]

    def readings(self, control: bool) -> Dict[str, Dict[str, float]]:
        """The numbers the check compares and the gaps' quantiles, on the
        kept batches run once through the timed path (``calibrate.py``):
        the program's against the reference, and with ``control`` the
        control's (the reference in fp8) against it."""
        self.release()
        out = {"program": self.gaps()}
        if control:
            out["control"] = self.gaps("f32", against="fp8")
        qs = (0.5, 0.9, 0.99, 0.999)
        return {k: {"logits_rel_median": float(torch.median(g)),
                    "logits_rel_max": float(torch.max(g)),
                    **{f"q{q}": float(torch.quantile(g.float(), q))
                       for q in qs}}
                for k, g in out.items()}

    def replay(self) -> None:
        """Run the kept batches again through a new step of the timed path,
        outside any window (``calibrate.py``, with a fault planted)."""
        from repro_torch.models.registry import build_model
        from repro_torch.training.step import make_prefill_step
        self.kept = {}
        step = make_prefill_step(build_model(model_config(self.cfg),
                                             self.ctx.device))
        for i in sorted(self.keep):
            self.kept[i] = step(self.params, {"tokens": self.tokens[i]})
