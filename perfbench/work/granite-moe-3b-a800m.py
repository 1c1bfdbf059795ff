"""Work counts of the ``granite-moe-3b-a800m`` configuration from its
shapes.  FLOPs count products only, two per multiply-add.

A token's active matmul parameters: per layer the attention projections
(q and o d x d, k and v d x (kv heads x head size)), the router (d x E)
and its k experts' three d x F matrices: 807 272 448 over 32 layers; the
LM head adds d x vocab_size (the published vocabulary, not the padded
one).  The same work is counted whatever computes it, so a change to the
routing's drops does not change it.  Causal attention adds, per layer and
sequence, 2 x 2 x heads x head size x S(S+1)/2 (scores and their product
with V, over the positions each query sees).

The flash-attention kernel's bound per launch (one a layer, over the whole
batch) is the larger of its FLOPs over the bf16 peak and its bytes over
HBM bandwidth: q, k, v read once and o written once, in bf16.
"""
from __future__ import annotations

from typing import Dict

BF16 = 2

KERNEL = "flash_fwd"          # the flash kernels' names in the trace start so


def _dims(cfg: Dict):
    d = cfg["hidden_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return d, h, kv, d // h


def layer_active_params(cfg: Dict) -> int:
    d, h, kv, hd = _dims(cfg)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    router = d * cfg["num_local_experts"]
    experts = cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"]
    return attn + router + experts


def active_params(cfg: Dict) -> int:
    """Matmul parameters a token uses, the LM head included."""
    return (cfg["num_hidden_layers"] * layer_active_params(cfg)
            + cfg["hidden_size"] * cfg["vocab_size"])


def attention_flops(cfg: Dict, b: int, s: int) -> float:
    """One layer's causal attention over a batch of b sequences of s."""
    _, h, _, hd = _dims(cfg)
    return 2.0 * 2.0 * h * hd * b * s * (s + 1) / 2.0


def batch_flops(cfg: Dict, b: int, s: int) -> float:
    return (2.0 * b * s * active_params(cfg)
            + cfg["num_hidden_layers"] * attention_flops(cfg, b, s))


def flash_bound_s(cfg: Dict, b: int, s: int, peaks: Dict) -> float:
    """The flash kernel's bound over one batch: its launches, one a
    layer."""
    _, h, kv, hd = _dims(cfg)
    nbytes = BF16 * b * s * hd * (2 * h + 2 * kv)
    one = max(attention_flops(cfg, b, s) / peaks["bf16_flops_per_s"],
              nbytes / peaks["hbm_bytes_per_s"])
    return cfg["num_hidden_layers"] * one
