"""Plain reference of the ``granite-moe-3b-a800m`` configuration as the
benchmark runs it: the decoder's full-sequence forward (prefill) in
float32 with TF32 off, layer by layer over a whole batch.

Per layer: RMSNorm; grouped-query attention with rotary positions
(rotate-half, theta from the configuration), causal, scaled by the
configuration's ``attention_multiplier``; the residual; RMSNorm; the
mixture of experts: a router softmax over the experts, the top
``num_experts_per_tok`` (the lower index first among equal
probabilities), their weights renormalised to sum to 1, each expert's
SwiGLU (silu(x Wg) * (x Wu)) Wd; an expert takes at most
max(8, int(capacity_factor * T * k / E + 0.5)) routes of the batch's T
tokens, in token order (routes of earlier tokens first, a token's routes
in rank order), and a route past that is dropped; the residual.  Then
RMSNorm and the LM head over the real vocabulary.

The weights are the benchmark's (``inputs.zoo_weights``), in the tree
the benchmark made for the program: ``embed.table`` (V', d),
``layers.{norm1,norm2}.scale`` (L, d), ``layers.attn.{wq,wk,wv,wo}``
(L, in, out), ``layers.moe.router`` (L, d, E),
``layers.moe.experts.{w_gate,w_up,w_down}`` (L, E, in, out),
``final_norm.scale`` (d,), ``head.w`` (d, V').

``precision="fp8"`` is the control: every product's two operands rounded
to float8 e4m3 with one absmax scale per operand (activations per tensor,
weights per matrix), the products and everything else still in f32.

Imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

E4M3_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 under one absmax scale, back in f32."""
    s = E4M3_MAX / torch.clamp_min(x.abs().amax(), 1e-30)
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Ops:
    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _q8(a), _q8(b)
        return a @ b


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by its positions 0..S-1 (rotate-half)."""
    _, s, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(ops, cfg, lp, i, h):
    b, s, d = h.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    q = ops.mm(h, lp["wq"][i]).reshape(b, s, nh, hd)
    k = ops.mm(h, lp["wk"][i]).reshape(b, s, nkv, hd)
    v = ops.mm(h, lp["wv"][i]).reshape(b, s, nkv, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    g = nh // nkv
    q = q.permute(0, 2, 1, 3)                                   # (B, H, S, D)
    k = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = torch.empty_like(q)
    rows = max(1, (1 << 28) // (nh * s * s))                    # ~1 GiB scores
    for r in range(0, b, rows):
        sc = ops.mm(q[r:r + rows], k[r:r + rows].transpose(-1, -2)) \
            * cfg["attention_multiplier"]
        sc = torch.where(causal, sc, -torch.inf)
        out[r:r + rows] = ops.mm(torch.softmax(sc, dim=-1), v[r:r + rows])
    return ops.mm(out.permute(0, 2, 1, 3).reshape(b, s, d), lp["wo"][i])


def _moe(ops, cfg, mp, i, h):
    b, s, d = h.shape
    t = b * s
    n_e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    x = h.reshape(t, d)
    probs = torch.softmax(ops.mm(x, mp["router"][i]), dim=-1)  # (T, E)
    order = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    w = torch.gather(probs, 1, order)
    w = w / w.sum(dim=-1, keepdim=True)
    cap = max(8, int(cfg["capacity_factor"] * t * k / n_e + 0.5))
    flat = order.reshape(-1)                                    # token-major
    y = torch.zeros_like(x)
    ex = mp["experts"]
    for e in range(n_e):
        routes = torch.nonzero(flat == e).reshape(-1)[:cap]
        if routes.numel() == 0:
            continue
        tok = routes // k
        xe = x[tok]
        he = torch.nn.functional.silu(ops.mm(xe, ex["w_gate"][i, e])) \
            * ops.mm(xe, ex["w_up"][i, e])
        ye = ops.mm(he, ex["w_down"][i, e])
        y.index_add_(0, tok, ye * w.reshape(-1)[routes][:, None])
    return y.reshape(b, s, d)


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@torch.no_grad()
def prefill_logits(cfg: Dict, params: Dict, tokens: torch.Tensor,
                   precision: str = "f32") -> torch.Tensor:
    """Logits (B, S, vocab_size) f32 of ``tokens`` (B, S)."""
    ops = _Ops(precision == "fp8")
    eps = cfg["rms_norm_eps"]
    lp = params["layers"]
    with _no_tf32():
        x = params["embed"]["table"][tokens].float() \
            * cfg["embedding_multiplier"]
        for i in range(cfg["num_hidden_layers"]):
            h = _rmsnorm(x, lp["norm1"]["scale"][i], eps)
            x = x + cfg["residual_multiplier"] * _attention(
                ops, cfg, lp["attn"], i, h)
            h = _rmsnorm(x, lp["norm2"]["scale"][i], eps)
            x = x + cfg["residual_multiplier"] * _moe(ops, cfg, lp["moe"],
                                                      i, h)
        x = _rmsnorm(x, params["final_norm"]["scale"], eps)
        w = params["head"]["w"][:, :cfg["vocab_size"]]
        return ops.mm(x, w) / cfg["logits_scaling"]
