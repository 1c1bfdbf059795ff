"""GQA attention: full-sequence (train/prefill) and single-token decode
(``repro/models/attention.py``).

Supports grouped KV heads, optional QKV bias (qwen2), causal or
bidirectional masking, sliding-window masking (dense long-context
variant), RoPE/M-RoPE applied at write time (the KV cache stores rotated
keys), and a ring-buffer cache for windowed decode.

Full-sequence attention takes one of two paths (``module.einsum_path``):

- inference on plain tensors (``torch.no_grad()``, or no input that needs
  a gradient): the flash-attention wrapper
  (``repro_torch.kernels.flash_attention``) for ``impl="xla"`` and
  ``impl="flash"`` alike.  On a CUDA tensor it launches the CUDA kernel,
  on a CPU tensor it runs the kernel's twin;
- training, and any ``DTensor`` input (the dry run, sharded ranks): the
  reference's own ``impl="xla"`` computation, ``_sdpa`` with
  ``full_mask`` up to ``CHUNK_THRESHOLD`` tokens and ``_sdpa_chunked``
  above it, in plain torch.  The kernel has no backward, nor has the
  reference's (``jax.grad`` through ``impl="flash"`` fails), and it takes
  no DTensor, so ``impl="flash"`` raises there.

``act`` (the activation sharding map, ``sharding/apply.py``) constrains
``_sdpa_chunked``'s q/k/v and the attention output where the reference
does; it changes nothing on plain tensors.

Decode attends one query over the ring-buffer cache with ``_sdpa`` in
plain torch, as the reference does: that computation lies outside any
kernel there, and its mask is not the kernel's end-aligned causal mask.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import module as m
from repro_torch.models.rope import apply_rope, rope_angles
from repro_torch.sharding import apply as sh
from repro_torch.sharding.apply import (batch_shardable, constrain,
                                        heads_shardable)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

IMPLS = ("xla", "flash")       # both name the kernel path in inference

CHUNK_THRESHOLD = 1024     # beyond this, training takes the q-chunked path
Q_CHUNK = 256


def init_attention(gen, cfg: ModelConfig, device=None):
    pdt = m.dtype_of(cfg.param_dtype)
    p = {
        "wq": m.dense_init(gen, cfg.d_model, cfg.q_dim, device, dtype=pdt),
        "wk": m.dense_init(gen, cfg.d_model, cfg.kv_dim, device, dtype=pdt),
        "wv": m.dense_init(gen, cfg.d_model, cfg.kv_dim, device, dtype=pdt),
        "wo": m.dense_init(gen, cfg.q_dim, cfg.d_model, device, dtype=pdt),
    }
    if cfg.qkv_bias:
        p["bq"] = m.zeros((cfg.q_dim,), device, pdt)
        p["bk"] = m.zeros((cfg.kv_dim,), device, pdt)
        p["bv"] = m.zeros((cfg.kv_dim,), device, pdt)
    return p


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor):
    dt = x.dtype
    B, S, _ = x.shape
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = sh.reshape(q, B, S, cfg.num_heads, cfg.head_dim)
    k = sh.reshape(k, B, S, cfg.num_kv_heads, cfg.head_dim)
    v = sh.reshape(v, B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """Grouped scaled-dot-product attention in plain torch.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); mask: broadcastable to
    (B, KV, G, Sq, Sk) with True = attend.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = sh.reshape(q, B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = scores * (D ** -0.5)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return sh.reshape(out, B, Sq, H * D)


def full_mask(cfg: ModelConfig, seq: int, device=None) -> torch.Tensor:
    """(1, 1, 1, S, S) boolean mask for full-sequence attention."""
    qpos = torch.arange(seq, device=device)[:, None]
    kpos = torch.arange(seq, device=device)[None, :]
    mask = torch.ones((seq, seq), dtype=torch.bool, device=device)
    if cfg.causal:
        mask &= kpos <= qpos
    if cfg.sliding_window:
        mask &= (qpos - kpos) < cfg.sliding_window
    return mask[None, None, None]


def _sdpa_chunked(cfg: ModelConfig, q, k, v, act=None) -> torch.Tensor:
    """Memory-efficient attention for training: a loop over query chunks
    of ``Q_CHUNK`` rows, KV repeated to (B, Sk, H, D), each chunk's body
    recomputed in the backward (``checkpoint``), so the full (S, S) score
    tensor is never held.  q: (B, Sq, H, D) with Sq % Q_CHUNK == 0.  With
    ``act``, q/k/v take the canonical layout: batch over data (and pod),
    heads over model where they divide it."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        # the reference's jnp.repeat on the head axis, as a broadcast: its
        # backward is a sum over the group, where repeat_interleave's
        # adds with atomics on the card (not bitwise repeatable)
        rep = lambda a: sh.reshape(a[:, :, :, None].expand(
            B, a.shape[1], KV, H // KV, D), B, a.shape[1], H, D)
        k, v = rep(k), rep(v)
    h_ax = "M" if heads_shardable(act, H) else None
    q = constrain(q, act, "B", None, h_ax, None)
    k = constrain(k, act, "B", None, h_ax, None)
    v = constrain(v, act, "B", None, h_ax, None)
    if Sq % Q_CHUNK:
        raise ValueError(f"_sdpa_chunked: Sq={Sq} is not a multiple of "
                         f"Q_CHUNK={Q_CHUNK}")
    qkv = (0, 2)                                  # batch, heads
    return sh.split_map(functools.partial(_chunked_local, cfg), (q, k, v),
                        [qkv] * 3, [qkv])


def _chunked_local(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    """``_sdpa_chunked``'s loop on tensors of one device: q, k, v
    (B, S, H, D) with k and v already repeated to H heads."""
    B, Sq, H, D = q.shape
    scale = D ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]

    def chunk_body(qc: torch.Tensor, q0: int) -> torch.Tensor:
        s = torch.einsum("bqhd,bkhd->bhqk", qc, k).to(torch.float32) * scale
        qpos = q0 + torch.arange(Q_CHUNK, device=q.device)[:, None]
        mask = torch.ones((Q_CHUNK, k.shape[1]), dtype=torch.bool,
                          device=q.device)
        if cfg.causal:
            mask &= kpos <= qpos
        if cfg.sliding_window:
            mask &= (qpos - kpos) < cfg.sliding_window
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    outs = [checkpoint(chunk_body, q[:, q0:q0 + Q_CHUNK], q0,
                       use_reentrant=False)
            for q0 in range(0, Sq, Q_CHUNK)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H * D)


def attend_full(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, impl: str = "xla",
                act=None) -> torch.Tensor:
    """Full-sequence attention for train/prefill.  x: (B, S, d)."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    q, k, v = _project_qkv(params, cfg, x)
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.mrope_sections)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    S = x.shape[1]
    if not m.einsum_path(q, k, v):
        out = fa_ops.flash_attention(q, k, v, causal=cfg.causal,
                                     window=cfg.sliding_window or 0)
        out = out.reshape(*x.shape[:2], cfg.q_dim)
    elif impl == "flash":
        raise NotImplementedError(
            "impl='flash' under autograd or on DTensors: the flash-attention "
            "kernel has no backward, nor has the reference's (jax.grad "
            "through impl='flash' fails), and it takes no DTensor; train "
            "and shard with impl='xla'")
    elif S > CHUNK_THRESHOLD and S % Q_CHUNK == 0:
        out = _sdpa_chunked(cfg, q, k, v, act)
    else:
        # heads whole: q's and the kv heads' groups need not split alike
        out = sh.split_map(functools.partial(_sdpa, cfg),
                           (q, k, v, full_mask(cfg, S, x.device)),
                           [(0, None)] * 3 + [(None, None)], [(0, None)])
    out = constrain(out, act, "B", None, None)
    return out @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, context_len: int) -> int:
    """Physical cache length: window ring buffer if windowed, else context."""
    if cfg.sliding_window and cfg.sliding_window < context_len:
        return cfg.sliding_window
    return context_len


def init_cache(cfg: ModelConfig, batch: int, context_len: int, dtype,
               device=None) -> Dict[str, torch.Tensor]:
    C = cache_len(cfg, context_len)
    shape = (batch, C, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_decode(params, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], position: torch.Tensor,
                  act=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); position: (B,) absolute positions of
    the new token; cache stores rotated keys.  Returns (out (B,1,d), cache').
    With ``act`` the new token's q, k and v take the batch's layout and
    whole heads (the cache keeps its own), where GSPMD would carry them."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)                    # S == 1
    b = "B" if batch_shardable(act, B) else None
    q, k, v = (constrain(t, act, b, None, None, None) for t in (q, k, v))
    pos = position[:, None]                                   # (B, 1)
    if cfg.mrope_sections:
        pos = pos[:, None].expand(B, 3, 1)
    angles = rope_angles(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)

    C = cache["k"].shape[1]
    slot = (position % C).long()                              # ring index (B,)
    onehot = torch.nn.functional.one_hot(slot, C).to(cache["k"].dtype)
    keep = (1 - onehot)[:, :, None, None]
    put = onehot[:, :, None, None]
    new_k = cache["k"] * keep + put * k
    new_v = cache["v"] * keep + put * v

    # validity: entries written so far; windowed cache recycles all slots
    idx = torch.arange(C, device=x.device)[None, :]           # (1, C)
    n_valid = torch.clamp(position + 1, max=C)[:, None]       # (B, 1)
    valid = idx < n_valid                                     # (B, C)
    mask = valid[:, None, None, None, :]                      # (B,1,1,1,C)
    out = _sdpa(cfg, q, new_k, new_v, mask)
    out = out @ params["wo"].to(x.dtype)
    return out, {"k": new_k, "v": new_v}
