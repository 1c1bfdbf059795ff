"""Plain PyTorch twins of the four fused-CNN kernels (``repro/kernels/fused_cnn/ref.py``).

Each function computes what its CUDA kernel (``csrc/fused_cnn.cu``)
computes, on stacked ``(K, ...)`` cohorts:

- ``conv_pool_fwd_k``: SAME 3x3 im2col patches, z = pat·W per user, 2x2
  max pool *before* bias + ReLU (``pool(relu(z+b)) == relu(pool(z)+b)``),
  and the residuals the backward consumes: the patches, the pool tie mask
  ``eq`` (1/count on tied maxima, jax's reduce-max rule) and the pooled
  ReLU mask.
- ``conv_pool_bwd_k``: the mask algebra and the two transposed products
  (dW = patᵀ·dz, dx = fold of dz·Wᵀ).
- ``fc_chain_fwd_k`` / ``fc_chain_bwd_k``: fc1+ReLU -> fc2+ReLU -> fc3 and
  its backward.

The conv product ``z`` is summed tap by tap in (i, j, c) order with a
rounded multiply and a rounded add per tap (``_conv_z``), exactly as the
CUDA kernel sums it.  Tied window maxima (zero image backgrounds, constant
inputs) are then found identically by the twin and the kernel, and the
``eq`` and ``relu_m`` masks agree bit for bit on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.cnn import _patches3x3


def patches3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9C) SAME-padded 3x3 patch view."""
    return _patches3x3(x)


def fold3x3(dpatches: torch.Tensor) -> torch.Tensor:
    """Transpose of ``patches3x3``: scatter-add (B,H,W,9C) -> (B,H,W,C),
    taps added in (i, j) order onto the padded canvas."""
    b, h, w, c9 = dpatches.shape
    c = c9 // 9
    dxp = dpatches.new_zeros((b, h + 2, w + 2, c))
    for idx in range(9):
        i, j = divmod(idx, 3)
        dxp[:, i:i + h, j:j + w, :] += dpatches[..., idx * c:(idx + 1) * c]
    return dxp[:, 1:1 + h, 1:1 + w, :].contiguous()


def _conv_z(pat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, M, P) x (K, P, O) -> (K, M, O), summed tap by tap in order."""
    acc = pat.new_zeros(pat.shape[:2] + (w.shape[-1],))
    for p in range(pat.shape[-1]):
        acc = acc + pat[:, :, p:p + 1] * w[:, p:p + 1, :]
    return acc


def conv_pool_fwd_k(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    residuals: bool = True):
    """x (K,B,H,W,C); w (K,3,3,C,O); b (K,O) -> a (K,B,H/2,W/2,O) and,
    when ``residuals``, (pat (K,B·H·W,9C), eq (K,B,H,W,O),
    relu_m (K,B,H/2,W/2,O)); else None."""
    k, bs, h, wd, c = x.shape
    o = w.shape[-1]
    pat = patches3x3(x.reshape(k * bs, h, wd, c)).reshape(
        k, bs * h * wd, 9 * c)
    z = _conv_z(pat, w.reshape(k, 9 * c, o)).reshape(k, bs, h, wd, o)
    zw = z.reshape(k, bs, h // 2, 2, wd // 2, 2, o)
    pz = zw.amax(dim=(3, 5))
    pre = pz + b.reshape(k, 1, 1, 1, o)
    a = torch.clamp_min(pre, 0.0)
    if not residuals:
        return a, None
    eqw = zw == pz[:, :, :, None, :, None, :]
    cnt = eqw.sum(dim=(3, 5), keepdim=True).to(x.dtype)
    eq = torch.where(eqw, 1.0 / cnt, 0.0).reshape(k, bs, h, wd, o)
    relu_m = (pre > 0).to(x.dtype)
    return a, (pat, eq, relu_m)


def conv_pool_bwd_k(res: Tuple, w: torch.Tensor, da: torch.Tensor,
                    need_dx: bool) -> Tuple:
    """da (K,B,H/2,W/2,O) -> (dw (K,3,3,C,O), db (K,O), dx (K,B,H,W,C)
    or None).  ``db`` sums at pooled resolution."""
    pat, eq, relu_m = res
    k, bs, h, wd, o = eq.shape
    c = pat.shape[-1] // 9
    dp = da * relu_m
    db = dp.sum(dim=(1, 2, 3))
    dz = (eq.reshape(k, bs, h // 2, 2, wd // 2, 2, o)
          * dp[:, :, :, None, :, None, :]).reshape(k, bs * h * wd, o)
    dw = torch.bmm(pat.transpose(1, 2), dz).reshape(k, 3, 3, c, o)
    dx = None
    if need_dx:
        dpat = torch.bmm(dz, w.reshape(k, 9 * c, o).transpose(1, 2))
        dx = fold3x3(dpat.reshape(k * bs, h, wd, 9 * c)).reshape(
            k, bs, h, wd, c)
    return dw, db, dx


def fc_chain_fwd_k(flat: torch.Tensor, params: dict) -> Tuple:
    """flat (K,B,F), stacked fc params -> logits (K,B,classes), (h1, h2)."""
    p1, p2, p3 = params["fc1"], params["fc2"], params["fc3"]
    h1 = torch.relu(torch.bmm(flat, p1["w"]) + p1["b"][:, None, :])
    h2 = torch.relu(torch.bmm(h1, p2["w"]) + p2["b"][:, None, :])
    logits = torch.bmm(h2, p3["w"]) + p3["b"][:, None, :]
    return logits, (h1, h2)


def fc_chain_bwd_k(flat: torch.Tensor, res: Tuple, params: dict,
                   dlogits: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """Per-user fc grads + dflat; the ReLU masks are ``h > 0``."""
    h1, h2 = res
    tr = lambda t: t.transpose(1, 2)
    g3 = {"w": torch.bmm(tr(h2), dlogits), "b": dlogits.sum(dim=1)}
    dh2 = torch.bmm(dlogits, tr(params["fc3"]["w"])) * (h2 > 0)
    g2 = {"w": torch.bmm(tr(h1), dh2), "b": dh2.sum(dim=1)}
    dh1 = torch.bmm(dh2, tr(params["fc2"]["w"])) * (h1 > 0)
    g1 = {"w": torch.bmm(tr(flat), dh1), "b": dh1.sum(dim=1)}
    dflat = torch.bmm(dh1, tr(params["fc1"]["w"]))
    return {"fc1": g1, "fc2": g2, "fc3": g3}, dflat


def forward_fwd_ref_k(params: dict, images: torch.Tensor):
    """Stacked-cohort forward + residuals: params leaves (K, ...),
    images (K,B,H,W,C)."""
    a1, r1 = conv_pool_fwd_k(images, params["conv1"]["w"],
                             params["conv1"]["b"])
    a2, r2 = conv_pool_fwd_k(a1, params["conv2"]["w"], params["conv2"]["b"])
    flat = a2.reshape(a2.shape[0], a2.shape[1], -1)
    logits, rfc = fc_chain_fwd_k(flat, params)
    return logits, (r1, r2, flat, rfc)


def backward_ref_k(params: dict, residuals, dlogits: torch.Tensor,
                   need_dx: bool = False):
    """Stacked-cohort hand-written backward: dlogits (K,B,classes) ->
    per-user grads (+ the image gradient when ``need_dx``)."""
    r1, r2, flat, rfc = residuals
    gfc, dflat = fc_chain_bwd_k(flat, rfc, params, dlogits)
    k, bs, h2_, w2_, o2 = r2[1].shape
    da2 = dflat.reshape(k, bs, h2_ // 2, w2_ // 2, o2)
    dw2, db2, da1 = conv_pool_bwd_k(r2, params["conv2"]["w"], da2, True)
    dw1, db1, dx = conv_pool_bwd_k(r1, params["conv1"]["w"], da1, need_dx)
    grads = {"conv1": {"w": dw1, "b": db1}, "conv2": {"w": dw2, "b": db2},
             **gfc}
    return grads, dx
