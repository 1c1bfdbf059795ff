"""Shared layers: RMSNorm, SwiGLU MLP, padded embeddings / LM head
(``repro/models/layers.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import module as m
from repro_torch.sharding.apply import is_dtensor, take_rows


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, device=None, dtype=torch.float32):
    return {"scale": m.ones((dim,), device, dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each step rounded to x's dtype: the op sequence
    XLA lowers ``jax.nn.sigmoid`` to.  At bf16 ``torch.sigmoid`` (one f32
    evaluation, one rounding) differs from it on a third of the values."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x), two roundings, as ``jax.nn.silu``."""
    return x * sigmoid(x)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, device=None):
    d_ff = cfg.d_ff
    pdt = m.dtype_of(cfg.param_dtype)
    return {
        "w_gate": m.dense_init(gen, cfg.d_model, d_ff, device, dtype=pdt),
        "w_up": m.dense_init(gen, cfg.d_model, d_ff, device, dtype=pdt),
        "w_down": m.dense_init(gen, d_ff, cfg.d_model, device, dtype=pdt),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_up"].to(dt)
    return (silu(gate) * up) @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings (vocab padded to a multiple of 256, as in the reference)
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig, device=None):
    pdt = m.dtype_of(cfg.param_dtype)
    return {"table": m.embed_init(gen, cfg.vocab_padded, cfg.d_model, device,
                                  pdt)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table in ``dtype`` (only the gathered rows are cast,
    which gives the reference's cast-then-gather values); a DTensor table
    through ``sharding.apply.take_rows``."""
    table = params["table"]
    if is_dtensor(table):
        return take_rows(table, tokens).to(dtype)
    return table[tokens.long()].to(dtype)


def init_lm_head(gen, cfg: ModelConfig, device=None):
    if cfg.tie_embeddings:
        return {}
    pdt = m.dtype_of(cfg.param_dtype)
    return {"w": m.dense_init(gen, cfg.d_model, cfg.vocab_padded, device,
                              dtype=pdt)}


def lm_logits(head_params, embed_params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab; padded slots masked to a large negative."""
    if cfg.tie_embeddings:
        logits = x @ embed_params["table"].to(x.dtype).T
    else:
        logits = x @ head_params["w"].to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        mask = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e9)
    return logits
