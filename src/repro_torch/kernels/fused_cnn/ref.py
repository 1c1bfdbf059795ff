"""Plain PyTorch twins of the eight fused-CNN kernels
(``repro/kernels/fused_cnn/ref.py``).

Each function computes what its CUDA kernel (``csrc/fused_cnn.cu``)
computes.  The blocked twins take stacked ``(K, ...)`` cohorts:

- ``conv_pool_fwd_k``: SAME 3x3 im2col patches, z = pat·W per user, 2x2
  max pool *before* bias + ReLU (``pool(relu(z+b)) == relu(pool(z)+b)``),
  and the residuals the backward consumes: the patches, the pool tie mask
  ``eq`` (1/count on tied maxima, jax's reduce-max rule) and the pooled
  ReLU mask.
- ``conv_pool_bwd_k``: the mask algebra and the two transposed products
  (dW = patᵀ·dz, dx = fold of dz·Wᵀ).
- ``fc_chain_fwd_k`` / ``fc_chain_bwd_k``: fc1+ReLU -> fc2+ReLU -> fc3 and
  its backward.

The single-user twins (``conv_pool_fwd``, ``conv_pool_bwd``,
``fc_chain_fwd``, ``fc_chain_bwd``: one user, no leading K) are the blocked
ones at K=1: the blocked body at one user is the same contraction.

The conv product ``z`` is summed tap by tap in (i, j, c) order with a
rounded multiply and a rounded add per tap (``_conv_z``), exactly as the
CUDA kernel sums it.  Tied window maxima (zero image backgrounds, constant
inputs) are then found identically by the twin and the kernel, and the
``eq`` and ``relu_m`` masks agree bit for bit on the card.

**Compute dtype.**  The dtype of the inputs (f32, or bf16 under the
mixed-precision policy) is the compute dtype D; products always accumulate
in f32, and grads of the weights and biases come back f32.  At bf16 the
values round to D where the reference's do on the CPU:

- conv z = D(Σ f32), summed tap by tap and rounded once (a product of two
  bf16 values is exact in f32); pool max of the rounded z; pre =
  D(pz + b); a = max(pre, 0); eq = D(1/count), the count taken on the
  rounded z;
- dp = D(da·relu_m); dz = D(eq·dp); db = Σ f32(dp); dpat = D(Σ f32); the
  fold adds the nine taps' slices in (i, j) order, rounding to D each
  time;
- fc h = max(D(D(Σ f32) + b), 0): XLA on the CPU rounds the product
  before the bias add (checked against ``jax.jit`` of the reference);
  dh = D(D(Σ)·mask); dflat = D(Σ);
- dW = Σ f32, unrounded, blocked and single-user alike.  The reference's
  blocked twins write ``_bdot32`` (a bf16 product widened to f32), but
  under ``jax.jit`` XLA on the CPU drops that rounding (the convert pair
  goes under ``xla_allow_excess_precision``), and the Pallas kernels in
  interpret mode never round: both give dW equal to the unrounded f32 sum
  on every element, where rounding it would differ on about half of them.
  Only the reference run op by op, without jit, rounds;
- the bf16 SGD step of the epoch (``ops.make_stacked_epoch_fn``) is
  p = D(p − D(D(lr)·D(g))): XLA converts the Python lr to bf16 and rounds
  the product and the difference, bitwise equal to the reference under
  jit.

At f32 every rounding is the identity, so the f32 twins round nowhere
but in f32 arithmetic itself.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.cnn import _patches3x3

f32 = torch.float32


def patches3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9C) SAME-padded 3x3 patch view."""
    return _patches3x3(x)


def fold3x3(dpatches: torch.Tensor) -> torch.Tensor:
    """Transpose of ``patches3x3``: scatter-add (B,H,W,9C) -> (B,H,W,C),
    taps added in (i, j) order onto the padded canvas (each add rounds to
    the input's dtype)."""
    b, h, w, c9 = dpatches.shape
    c = c9 // 9
    dxp = dpatches.new_zeros((b, h + 2, w + 2, c))
    for idx in range(9):
        i, j = divmod(idx, 3)
        dxp[:, i:i + h, j:j + w, :] += dpatches[..., idx * c:(idx + 1) * c]
    return dxp[:, 1:1 + h, 1:1 + w, :].contiguous()


def _conv_z(pat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, M, P) x (K, P, O) -> (K, M, O) in pat's dtype, summed tap by tap
    in order in f32 and rounded once."""
    pf, wf = pat.to(f32), w.to(f32)
    acc = pf.new_zeros(pat.shape[:2] + (w.shape[-1],))
    for p in range(pat.shape[-1]):
        acc = acc + pf[:, :, p:p + 1] * wf[:, p:p + 1, :]
    return acc.to(pat.dtype)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with f32 accumulation, rounded once to a's dtype."""
    return torch.bmm(a.to(f32), b.to(f32)).to(a.dtype)


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A weight gradient: the batched product in f32, unrounded."""
    return torch.bmm(a.to(f32), b.to(f32))


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
    cnt = eqw.sum(dim=(3, 5), keepdim=True).to(f32)
    eq = torch.where(eqw, (1.0 / cnt).to(x.dtype), 0.0).reshape(
        k, bs, h, wd, o)
    relu_m = (pre > 0).to(x.dtype)
    return a, (pat, eq, relu_m)


def conv_pool_bwd_k(res: Tuple, w: torch.Tensor, da: torch.Tensor,
                    need_dx: bool) -> Tuple:
    """da (K,B,H/2,W/2,O) -> (dw (K,3,3,C,O) f32, db (K,O) f32,
    dx (K,B,H,W,C) or None).  ``db`` sums at pooled resolution."""
    pat, eq, relu_m = res
    k, bs, h, wd, o = eq.shape
    c = pat.shape[-1] // 9
    dp = da * relu_m
    db = dp.to(f32).sum(dim=(1, 2, 3))
    dz = (eq.reshape(k, bs, h // 2, 2, wd // 2, 2, o)
          * dp[:, :, :, None, :, None, :]).reshape(k, bs * h * wd, o)
    dw = _bmm32(pat.transpose(1, 2), dz).reshape(k, 3, 3, c, o)
    dx = None
    if need_dx:
        dpat = _bmm(dz, w.reshape(k, 9 * c, o).transpose(1, 2))
        dx = fold3x3(dpat.reshape(k * bs, h, wd, 9 * c)).reshape(
            k, bs, h, wd, c)
    return dw, db, dx


def fc_chain_fwd_k(flat: torch.Tensor, params: dict) -> Tuple:
    """flat (K,B,F), stacked fc params -> logits (K,B,classes), (h1, h2)."""
    p1, p2, p3 = params["fc1"], params["fc2"], params["fc3"]
    h1 = torch.relu(_bmm(flat, p1["w"]) + p1["b"][:, None, :])
    h2 = torch.relu(_bmm(h1, p2["w"]) + p2["b"][:, None, :])
    logits = _bmm(h2, p3["w"]) + p3["b"][:, None, :]
    return logits, (h1, h2)


def fc_chain_bwd_k(flat: torch.Tensor, res: Tuple, params: dict,
                   dlogits: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """Per-user fc grads (f32) + dflat; the ReLU masks are ``h > 0``."""
    h1, h2 = res
    tr = lambda t: t.transpose(1, 2)
    g3 = {"w": _bmm32(tr(h2), dlogits),
          "b": dlogits.to(f32).sum(dim=1)}
    dh2 = _bmm(dlogits, tr(params["fc3"]["w"])) * (h2 > 0)
    g2 = {"w": _bmm32(tr(h1), dh2), "b": dh2.to(f32).sum(dim=1)}
    dh1 = _bmm(dh2, tr(params["fc2"]["w"])) * (h1 > 0)
    g1 = {"w": _bmm32(tr(flat), dh1),
          "b": dh1.to(f32).sum(dim=1)}
    dflat = _bmm(dh1, tr(params["fc1"]["w"]))
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


# ---------------------------------------------------------------------------
# single-user twins: one user's step, no leading K
# ---------------------------------------------------------------------------

def _one(t):
    """One user's tensor as a cohort of one (a view)."""
    return None if t is None else t.unsqueeze(0)


def _first(t):
    return None if t is None else t[0]


def _lead(params: dict) -> dict:
    """One user's params as a cohort of one (views)."""
    return {n: {leaf: t.unsqueeze(0) for leaf, t in params[n].items()}
            for n in params}


def conv_pool_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (B,H,W,C); w (3,3,C,O); b (O,) -> a (B,H/2,W/2,O) and residuals
    (pat (B·H·W,9C), eq (B,H,W,O), relu_m (B,H/2,W/2,O))."""
    a, res = conv_pool_fwd_k(_one(x), _one(w), _one(b))
    return a[0], tuple(r[0] for r in res)


def conv_pool_bwd(res: Tuple, w: torch.Tensor, da: torch.Tensor,
                  need_dx: bool) -> Tuple:
    """da (B,H/2,W/2,O) -> (dw (3,3,C,O) f32, db (O,) f32, dx (B,H,W,C) or
    None)."""
    out = conv_pool_bwd_k(tuple(_one(r) for r in res), _one(w), _one(da),
                          need_dx)
    return tuple(_first(t) for t in out)


def fc_chain_fwd(flat: torch.Tensor, params: dict) -> Tuple:
    """flat (B,F), one user's fc params -> logits (B,classes), (h1, h2)."""
    logits, (h1, h2) = fc_chain_fwd_k(_one(flat), _lead(params))
    return logits[0], (h1[0], h2[0])


def fc_chain_bwd(flat: torch.Tensor, res: Tuple, params: dict,
                 dlogits: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """One user's fc grads (f32) + dflat (B,F)."""
    grads, dflat = fc_chain_bwd_k(_one(flat), tuple(_one(r) for r in res),
                                  _lead(params), _one(dlogits))
    return ({n: {leaf: t[0] for leaf, t in g.items()}
             for n, g in grads.items()}, dflat[0])


def forward_fwd_ref(params: dict, images: torch.Tensor):
    """One user's forward + residuals: images (B,H,W,C)."""
    a1, r1 = conv_pool_fwd(images, params["conv1"]["w"],
                           params["conv1"]["b"])
    a2, r2 = conv_pool_fwd(a1, params["conv2"]["w"], params["conv2"]["b"])
    flat = a2.reshape(a2.shape[0], -1)
    logits, rfc = fc_chain_fwd(flat, params)
    return logits, (r1, r2, flat, rfc)


def forward_ref(params: dict, images: torch.Tensor) -> torch.Tensor:
    """One user's logits (no residuals kept)."""
    return forward_fwd_ref(params, images)[0]


def backward_ref(params: dict, residuals, dlogits: torch.Tensor,
                 need_dx: bool = True):
    """One user's hand-written backward: dlogits (B,classes) -> grads
    (+ the image gradient when ``need_dx``)."""
    r1, r2, flat, rfc = residuals
    gfc, dflat = fc_chain_bwd(flat, rfc, params, dlogits)
    bs, h2_, w2_, o2 = r2[1].shape
    da2 = dflat.reshape(bs, h2_ // 2, w2_ // 2, o2)
    dw2, db2, da1 = conv_pool_bwd(r2, params["conv2"]["w"], da2, True)
    dw1, db1, dx = conv_pool_bwd(r1, params["conv1"]["w"], da1, need_dx)
    grads = {"conv1": {"w": dw1, "b": db1}, "conv2": {"w": dw2, "b": db2},
             **gfc}
    return grads, dx
