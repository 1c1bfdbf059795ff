"""Wrappers of the four fused-CNN CUDA kernels (``csrc/fused_cnn.cu``).

Counterparts of the blocked Pallas kernels of
``repro/kernels/fused_cnn/kernel.py`` (``conv_pool_fwd_k``,
``conv_pool_bwd_k``, ``fc_chain_fwd_k``, ``fc_chain_bwd_k``), with the
same stacked ``(K, ...)`` layouts.  On CPU tensors a wrapper runs the
plain twin of ``ref.py``; on CUDA tensors it checks dtype (f32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream and raises on a launch error.  There is no fallback from
the card to the twin.

``LAUNCHES`` counts, per wrapper, the ``__global__`` launches it made
(``conv_pool_bwd_k`` and ``fc_chain_bwd_k`` make two per call).  The TPU
kernels tile their grid over ``block_k`` users; the CUDA kernels choose
their own tiling, so the port takes no ``block_k`` and needs no phantom
padding of the cohort.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_cnn import ref

LAUNCHES: Dict[str, int] = {"conv_pool_fwd_k": 0, "conv_pool_bwd_k": 0,
                            "fc_chain_fwd_k": 0, "fc_chain_bwd_k": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types before the stream
_LIB = _build.Library("fused_cnn", {
    "fcnn_conv_pool_fwd": [_P] * 7 + [_I] * 7,
    "fcnn_conv_bwd_partial": [_P] * 6 + [_I] * 8,
    "fcnn_conv_bwd_finish": [_P] * 8 + [_I] * 7,
    "fcnn_fc_fwd": [_P] * 10 + [_I] * 6,
    "fcnn_fc_bwd_act": [_P] * 7 + [_I] * 5,
    "fcnn_fc_bwd_grad": [_P] * 14 + [_I] * 6,
}, "fcnn_error_string", LAUNCHES)
reset_launches = _LIB.reset


def _ptr(t):
    return None if t is None else t.data_ptr()


def conv_pool_fwd_k(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    residuals: bool = True):
    """x (K,B,H,W,C), w (K,3,3,C,O), b (K,O) -> a (K,B,H/2,W/2,O) and the
    residuals (pat, eq, relu_m), or None when ``residuals`` is False (the
    eval forward skips writing them)."""
    if _build.on_cpu(x, w, b):
        return ref.conv_pool_fwd_k(x, w, b, residuals)
    k, bs, h, wd, c = x.shape
    o = w.shape[-1]
    _build.check("x", x, (k, bs, h, wd, c))
    _build.check("w", w, (k, 3, 3, c, o))
    _build.check("b", b, (k, o))
    if h % 2 or wd % 2 or bs < 1 or k < 1:
        raise ValueError(f"conv_pool_fwd_k: bad input shape {tuple(x.shape)}")
    new = lambda *s: torch.empty(s, dtype=x.dtype, device=x.device)
    a = new(k, bs, h // 2, wd // 2, o)
    pat = eq = relu_m = None
    if residuals:
        pat = new(k, bs * h * wd, 9 * c)
        eq = new(k, bs, h, wd, o)
        relu_m = new(k, bs, h // 2, wd // 2, o)
    with torch.cuda.device(x.device):
        _LIB.launch("conv_pool_fwd_k", "fcnn_conv_pool_fwd", x.data_ptr(),
                     w.data_ptr(), b.data_ptr(), a.data_ptr(), _ptr(pat), _ptr(eq),
                     _ptr(relu_m), k, bs, h, wd, c, o, int(residuals))
    return a, ((pat, eq, relu_m) if residuals else None)


def _rows_per_chunk(p: int, o: int) -> int:
    """Patch rows per block of the dW partial pass: at most 256, and the
    rows' patches + dz must fit 32 KB of shared memory."""
    r = 256
    while r > 1 and r * (p + o) * 4 > 32 * 1024:
        r //= 2
    return r


def conv_pool_bwd_k(res: Tuple, w: torch.Tensor, da: torch.Tensor,
                    need_dx: bool) -> Tuple:
    """(pat, eq, relu_m), w (K,3,3,C,O), da (K,B,H/2,W/2,O) ->
    (dw (K,3,3,C,O), db (K,O), dx (K,B,H,W,C) or None)."""
    pat, eq, relu_m = res
    if _build.on_cpu(pat, eq, relu_m, w, da):
        return ref.conv_pool_bwd_k(res, w, da, need_dx)
    k, bs, h, wd, o = eq.shape
    c = pat.shape[-1] // 9
    m = bs * h * wd
    _build.check("pat", pat, (k, m, 9 * c))
    _build.check("eq", eq, (k, bs, h, wd, o))
    _build.check("relu_m", relu_m, (k, bs, h // 2, wd // 2, o))
    _build.check("w", w, (k, 3, 3, c, o))
    _build.check("da", da, (k, bs, h // 2, wd // 2, o))
    if o > 256:
        raise ValueError(f"conv_pool_bwd_k: O={o} > 256 output channels")
    new = lambda *s: torch.empty(s, dtype=da.dtype, device=da.device)
    rows = _rows_per_chunk(9 * c, o)
    nchunks = -(-m // rows)
    # scratch between the two launches; freed on return while the launches
    # may still run, which is safe because PyTorch's caching allocator only
    # hands the memory to later work on the same (current) stream
    part = new(k, nchunks, 9 * c, o)
    dz = new(k, m, o)
    dw, db = new(k, 3, 3, c, o), new(k, o)
    dx = new(k, bs, h, wd, c) if need_dx else None
    with torch.cuda.device(da.device):
        _LIB.launch("conv_pool_bwd_k", "fcnn_conv_bwd_partial", pat.data_ptr(),
                     eq.data_ptr(), relu_m.data_ptr(), da.data_ptr(),
                     dz.data_ptr(), part.data_ptr(), k, bs, h, wd, c, o, rows,
                     nchunks)
        _LIB.launch("conv_pool_bwd_k", "fcnn_conv_bwd_finish", part.data_ptr(),
                     dz.data_ptr(), da.data_ptr(), relu_m.data_ptr(),
                     w.data_ptr(), dw.data_ptr(), db.data_ptr(), _ptr(dx), k, bs,
                     h, wd, c, o, nchunks)
    return dw, db, dx


def _fc_dims(flat: torch.Tensor, params: dict):
    k, bs, f = flat.shape
    d1 = params["fc1"]["w"].shape[-1]
    d2 = params["fc2"]["w"].shape[-1]
    d3 = params["fc3"]["w"].shape[-1]
    for name, (fin, fout) in (("fc1", (f, d1)), ("fc2", (d1, d2)),
                              ("fc3", (d2, d3))):
        _build.check(f"{name}.w", params[name]["w"], (k, fin, fout))
        _build.check(f"{name}.b", params[name]["b"], (k, fout))
    return k, bs, f, d1, d2, d3


def _fc_tensors(params: dict):
    return [params[n][leaf] for n in ("fc1", "fc2", "fc3")
            for leaf in ("w", "b")]


def fc_chain_fwd_k(flat: torch.Tensor, params: dict) -> Tuple:
    """flat (K,B,F), stacked fc params -> logits (K,B,D3), (h1, h2)."""
    if _build.on_cpu(flat, *_fc_tensors(params)):
        return ref.fc_chain_fwd_k(flat, params)
    k, bs, f, d1, d2, d3 = _fc_dims(flat, params)
    _build.check("flat", flat, (k, bs, f))
    new = lambda *s: torch.empty(s, dtype=flat.dtype, device=flat.device)
    logits, h1, h2 = new(k, bs, d3), new(k, bs, d1), new(k, bs, d2)
    p1, p2, p3 = params["fc1"], params["fc2"], params["fc3"]
    with torch.cuda.device(flat.device):
        _LIB.launch("fc_chain_fwd_k", "fcnn_fc_fwd", flat.data_ptr(),
                     p1["w"].data_ptr(), p1["b"].data_ptr(), p2["w"].data_ptr(),
                     p2["b"].data_ptr(), p3["w"].data_ptr(), p3["b"].data_ptr(),
                     logits.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                     k, bs, f, d1, d2, d3)
    return logits, (h1, h2)


def fc_chain_bwd_k(flat: torch.Tensor, res: Tuple, params: dict,
                   dlogits: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """Per-user fc grads {fc1,fc2,fc3: {w, b}} (f32) and dflat (K,B,F)."""
    h1, h2 = res
    if _build.on_cpu(flat, h1, h2, dlogits, *_fc_tensors(params)):
        return ref.fc_chain_bwd_k(flat, res, params, dlogits)
    k, bs, f, d1, d2, d3 = _fc_dims(flat, params)
    _build.check("flat", flat, (k, bs, f))
    _build.check("h1", h1, (k, bs, d1))
    _build.check("h2", h2, (k, bs, d2))
    _build.check("dlogits", dlogits, (k, bs, d3))
    new = lambda *s: torch.empty(s, dtype=flat.dtype, device=flat.device)
    dh1, dh2 = new(k, bs, d1), new(k, bs, d2)
    g1 = {"w": new(k, f, d1), "b": new(k, d1)}
    g2 = {"w": new(k, d1, d2), "b": new(k, d2)}
    g3 = {"w": new(k, d2, d3), "b": new(k, d3)}
    dflat = new(k, bs, f)
    p1, p2, p3 = params["fc1"], params["fc2"], params["fc3"]
    with torch.cuda.device(flat.device):
        _LIB.launch("fc_chain_bwd_k", "fcnn_fc_bwd_act", dlogits.data_ptr(),
                     h1.data_ptr(), h2.data_ptr(), p2["w"].data_ptr(),
                     p3["w"].data_ptr(), dh1.data_ptr(), dh2.data_ptr(),
                     k, bs, d1, d2, d3)
        _LIB.launch("fc_chain_bwd_k", "fcnn_fc_bwd_grad", flat.data_ptr(),
                     h1.data_ptr(), h2.data_ptr(), dlogits.data_ptr(),
                     dh1.data_ptr(), dh2.data_ptr(), p1["w"].data_ptr(),
                     g1["w"].data_ptr(), g1["b"].data_ptr(), g2["w"].data_ptr(),
                     g2["b"].data_ptr(), g3["w"].data_ptr(), g3["b"].data_ptr(),
                     dflat.data_ptr(), k, bs, f, d1, d2, d3)
    return {"fc1": g1, "fc2": g2, "fc3": g3}, dflat
