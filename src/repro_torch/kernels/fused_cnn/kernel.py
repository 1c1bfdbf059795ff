"""Wrappers of the eight fused-CNN CUDA kernels (``csrc/fused_cnn.cu``).

Counterparts of the Pallas kernels of ``repro/kernels/fused_cnn/kernel.py``
with the same layouts: the blocked ``conv_pool_fwd_k``, ``conv_pool_bwd_k``,
``fc_chain_fwd_k``, ``fc_chain_bwd_k`` on stacked ``(K, ...)`` cohorts, and
the single-user ``conv_pool_fwd``, ``conv_pool_bwd``, ``fc_chain_fwd``,
``fc_chain_bwd`` on one user's tensors (the ``batch_users=False`` path,
one launch per user slot).  On CPU tensors a wrapper runs the plain twin of
``ref.py``; on CUDA tensors it takes the compute dtype from its input (f32
or bf16; every compute tensor of a call in that dtype, anything else
raises), checks shape and contiguity, allocates its outputs with
``torch.empty`` (weight and bias grads always f32), launches on the current
stream and raises on a launch error.  There is no fallback from the card
to the twin.

``LAUNCHES`` counts, per wrapper, the ``__global__`` launches it made (one
per call, the conv backward included); ``LAUNCHES_BF16`` counts those of
them that ran the bf16 instantiation.  The TPU kernels tile their grid
over ``block_k`` users; the CUDA kernels choose their own tiling, so the
port takes no ``block_k`` and needs no phantom padding of the cohort.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_cnn import ref
from repro_torch.kernels.fused_cnn.ref import _first, _lead, _one

LAUNCHES: Dict[str, int] = {
    "conv_pool_fwd_k": 0, "conv_pool_bwd_k": 0, "fc_chain_fwd_k": 0,
    "fc_chain_bwd_k": 0, "conv_pool_fwd": 0, "conv_pool_bwd": 0,
    "fc_chain_fwd": 0, "fc_chain_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types before the stream; the last int is the compute dtype
# (0 = f32, 1 = bf16), and the single-user entries take no K
_LIB = _build.Library("fused_cnn", {
    "fcnn_conv_pool_fwd": [_P] * 7 + [_I] * 8,
    "fcnn_conv_pool_bwd": [_P] * 10 + [_I] * 9,
    "fcnn_fc_fwd": [_P] * 11 + [_I] * 9,
    "fcnn_fc_bwd": [_P] * 14 + [_I] * 7,
    "fcnn_user_conv_pool_fwd": [_P] * 7 + [_I] * 6,
    "fcnn_user_conv_pool_bwd": [_P] * 10 + [_I] * 8,
    "fcnn_user_fc_fwd": [_P] * 11 + [_I] * 8,
    "fcnn_user_fc_bwd": [_P] * 14 + [_I] * 6,
}, "fcnn_error_string", LAUNCHES)
LAUNCHES_BF16: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
f32 = torch.float32


def reset_launches() -> None:
    """Set every launch count (both dtypes) to 0."""
    _LIB.reset()
    for name in LAUNCHES_BF16:
        LAUNCHES_BF16[name] = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(user: bool, counter: str, fn: str, ptrs, k: int, ints) -> None:
    """Launch a blocked entry point (``k`` after the pointers) or its
    single-user twin (``fcnn_user_*``, no K) and count it under the blocked
    name + ``_k`` or the single-user name; the last of ``ints`` is the
    bf16 flag."""
    if user:
        _LIB.launch(counter, fn.replace("fcnn_", "fcnn_user_", 1), *ptrs,
                    *ints)
    else:
        counter += "_k"
        _LIB.launch(counter, fn, *ptrs, k, *ints)
    LAUNCHES_BF16[counter] += ints[-1]


# ---------------------------------------------------------------------------
# conv block
# ---------------------------------------------------------------------------

def _conv_pool_fwd(x, w, b, residuals: bool, user: bool):
    k, bs, h, wd, c = x.shape
    o = w.shape[-1]
    dt = _build.compute_dtype("x", x)
    _build.check("x", x, (k, bs, h, wd, c), dt)
    _build.check("w", w, (k, 3, 3, c, o), dt)
    _build.check("b", b, (k, o), dt)
    if h % 2 or wd % 2 or bs < 1 or k < 1:
        raise ValueError(f"conv_pool_fwd: bad input shape {tuple(x.shape)}")
    # the launcher narrows its bands of pooled rows until a block fits;
    # one row is the least it can take
    need = conv_fwd_smem(1, wd, c, o, x.element_size(), residuals)
    if need > CONV_SMEM_LIMIT:
        raise _too_big("conv_pool_fwd", need,
                       f"H={h} W={wd} C={c} O={o} residuals={residuals}")
    new = lambda *s: torch.empty(s, dtype=dt, device=x.device)
    a = new(k, bs, h // 2, wd // 2, o)
    pat = eq = relu_m = None
    if residuals:
        pat = new(k, bs * h * wd, 9 * c)
        eq = new(k, bs, h, wd, o)
        relu_m = new(k, bs, h // 2, wd // 2, o)
    ints = [bs, h, wd, c, o] + ([] if user else [int(residuals)]) \
        + [int(dt == torch.bfloat16)]
    with torch.cuda.device(x.device):
        _launch(user, "conv_pool_fwd", "fcnn_conv_pool_fwd",
                [x.data_ptr(), w.data_ptr(), b.data_ptr(), a.data_ptr(),
                 _ptr(pat), _ptr(eq), _ptr(relu_m)], k, ints)
    return a, ((pat, eq, relu_m) if residuals else None)


def conv_pool_fwd_k(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    residuals: bool = True):
    """x (K,B,H,W,C), w (K,3,3,C,O), b (K,O) -> a (K,B,H/2,W/2,O) and the
    residuals (pat, eq, relu_m), or None when ``residuals`` is False (the
    eval forward skips writing them)."""
    if _build.on_cpu(x, w, b):
        return ref.conv_pool_fwd_k(x, w, b, residuals)
    return _conv_pool_fwd(x, w, b, residuals, user=False)


def conv_pool_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One user: x (B,H,W,C), w (3,3,C,O), b (O,) -> a (B,H/2,W/2,O) and
    the residuals (pat (B·H·W,9C), eq (B,H,W,O), relu_m)."""
    if _build.on_cpu(x, w, b):
        return ref.conv_pool_fwd(x, w, b)
    a, res = _conv_pool_fwd(_one(x), _one(w), _one(b), True, user=True)
    return a[0], tuple(r[0] for r in res)


# shared memory a block of the conv pair may take: the H100's 227 KB
# (232 448 bytes) less 128 for the kernels' static flags; the launchers of
# csrc/fused_cnn.cu size against the same number (kConvSmemLimit)
CONV_SMEM_LIMIT = 227 * 1024 - 128


def _span(n: int, tsize: int) -> int:
    """Bytes of a span region of n elements: 16 to spare, whole 16s
    (``span_bytes`` of fused_cnn.cu)."""
    return (n * tsize + 31) // 16 * 16


def conv_fwd_smem(nph: int, wd: int, c: int, o: int, tsize: int,
                  residuals: bool) -> int:
    """Shared-memory bytes of a conv forward block over a band of ``nph``
    pooled rows (``ConvFwdSmem`` of fused_cnn.cu)."""
    tr = 2 * nph + 2
    total = _span(tr * wd * c, tsize) + (tr * (wd + 2) * c * 4 + 15) // 16 \
        * 16 + _span(9 * c * o, tsize) + _span(o, tsize) \
        + _span(nph * (wd // 2) * o, tsize)
    if residuals:
        total += _span(nph * (wd // 2) * o, tsize) \
            + _span(2 * nph * wd * o, tsize) \
            + _span(2 * nph * wd * 9 * c, tsize)
    return total


def conv_bwd_smem(rows: int, wd: int, c: int, o: int, tsize: int,
                  need_dx: bool) -> int:
    """Shared-memory bytes of a conv backward block over a chunk of
    ``rows`` patch rows (``ConvBwdSmem`` of fused_cnn.cu)."""
    n = rows + (2 * (wd + 1) if need_dx else 0)   # dz rows, halo included
    npr = (n + wd - 1) // wd // 2 + 2
    lw = o if o % 4 else o + 4
    total = _span(rows * 9 * c, tsize) + _span(n * o, tsize) \
        + 2 * _span(npr * (wd // 2) * o, tsize) + (n * o * 4 + 15) // 16 * 16 \
        + (n * 4 + 15) // 16 * 16
    if need_dx:
        total += _span(9 * c * o, tsize) + (9 * c * lw * 4 + 15) // 16 * 16
    return total


def _too_big(what: str, need: int, shape) -> ValueError:
    return ValueError(
        f"{what}: shape {shape} needs {need} bytes of shared memory for one "
        f"{'pooled row' if what == 'conv_pool_fwd' else 'patch row'}, over "
        f"the {CONV_SMEM_LIMIT} bytes a block may take (the H100's 227 KB "
        f"less the kernels' static flags)")


def _rows_per_chunk(c: int, o: int, wd: int, tsize: int,
                    need_dx: bool) -> int:
    """Patch rows per block of the conv backward (each block sums one dW
    partial over its rows): at most 256, the rows' patches + dz fit 32 KB
    as f32, and halved further until the block's shared memory fits
    ``CONV_SMEM_LIMIT`` (which moves no shape the paper runs).  The
    chunking fixes dW's summation order, so it is the same at bf16, and a
    change to it changes dW's bits.  Raises where not one row fits."""
    r = 256
    while r > 1 and r * (9 * c + o) * 4 > 32 * 1024:
        r //= 2
    while r > 1 and conv_bwd_smem(r, wd, c, o, tsize, need_dx) \
            > CONV_SMEM_LIMIT:
        r //= 2
    need = conv_bwd_smem(r, wd, c, o, tsize, need_dx)
    if need > CONV_SMEM_LIMIT:
        raise _too_big("conv_pool_bwd", need,
                       f"W={wd} C={c} O={o} dx={need_dx}")
    return r


def _conv_pool_bwd(res, w, da, need_dx: bool, user: bool):
    pat, eq, relu_m = res
    k, bs, h, wd, o = eq.shape
    c = pat.shape[-1] // 9
    m = bs * h * wd
    dt = _build.compute_dtype("da", da)
    _build.check("pat", pat, (k, m, 9 * c), dt)
    _build.check("eq", eq, (k, bs, h, wd, o), dt)
    _build.check("relu_m", relu_m, (k, bs, h // 2, wd // 2, o), dt)
    _build.check("w", w, (k, 3, 3, c, o), dt)
    _build.check("da", da, (k, bs, h // 2, wd // 2, o), dt)
    if o > 256:
        raise ValueError(f"conv_pool_bwd: O={o} > 256 output channels")
    new = lambda d, *s: torch.empty(s, dtype=d, device=da.device)
    rows = _rows_per_chunk(c, o, wd, da.element_size(), need_dx)
    nchunks = -(-m // rows)
    # scratch of the launch (every block's dW partial, which the last block
    # of each user adds up); freed on return while the launch may still
    # run, which is safe because PyTorch's caching allocator only hands the
    # memory to later work on the same (current) stream
    part = new(f32, k, nchunks, 9 * c, o)
    dw, db = new(f32, k, 3, 3, c, o), new(f32, k, o)
    dx = new(dt, k, bs, h, wd, c) if need_dx else None
    with torch.cuda.device(da.device):
        _launch(user, "conv_pool_bwd", "fcnn_conv_pool_bwd",
                [pat.data_ptr(), eq.data_ptr(), relu_m.data_ptr(),
                 da.data_ptr(), w.data_ptr(), part.data_ptr(),
                 _counters(da.device, k).data_ptr(),
                 dw.data_ptr(), db.data_ptr(), _ptr(dx)], k,
                [bs, h, wd, c, o, rows, nchunks, int(dt == torch.bfloat16)])
    return dw, db, dx


def conv_pool_bwd_k(res: Tuple, w: torch.Tensor, da: torch.Tensor,
                    need_dx: bool) -> Tuple:
    """(pat, eq, relu_m), w (K,3,3,C,O), da (K,B,H/2,W/2,O) ->
    (dw (K,3,3,C,O) f32, db (K,O) f32, dx (K,B,H,W,C) or None)."""
    if _build.on_cpu(*res, w, da):
        return ref.conv_pool_bwd_k(res, w, da, need_dx)
    return _conv_pool_bwd(res, w, da, need_dx, user=False)


def conv_pool_bwd(res: Tuple, w: torch.Tensor, da: torch.Tensor,
                  need_dx: bool) -> Tuple:
    """One user: (pat, eq, relu_m), w (3,3,C,O), da (B,H/2,W/2,O) ->
    (dw (3,3,C,O) f32, db (O,) f32, dx (B,H,W,C) or None)."""
    if _build.on_cpu(*res, w, da):
        return ref.conv_pool_bwd(res, w, da, need_dx)
    out = _conv_pool_bwd(tuple(_one(r) for r in res), _one(w), _one(da),
                         need_dx, user=True)
    return tuple(_first(t) for t in out)


# ---------------------------------------------------------------------------
# fc chain
# ---------------------------------------------------------------------------

def _fc_dims(flat: torch.Tensor, params: dict):
    k, bs, f = flat.shape
    dt = _build.compute_dtype("flat", flat)
    _build.check("flat", flat, (k, bs, f), dt)
    d1 = params["fc1"]["w"].shape[-1]
    d2 = params["fc2"]["w"].shape[-1]
    d3 = params["fc3"]["w"].shape[-1]
    for name, (fin, fout) in (("fc1", (f, d1)), ("fc2", (d1, d2)),
                              ("fc3", (d2, d3))):
        _build.check(f"{name}.w", params[name]["w"], (k, fin, fout), dt)
        _build.check(f"{name}.b", params[name]["b"], (k, fout), dt)
    return dt, k, bs, f, d1, d2, d3


def _fc_tensors(params: dict):
    return [params[n][leaf] for n in ("fc1", "fc2", "fc3")
            for leaf in ("w", "b")]


FC_FWD_MAX_ROWS = FC_FWD_MAX_COLS = 16     # fused_cnn.cu kFcMaxRows/Cols


def fc_fwd_tiling(k: int, bs: int, d1: int) -> Tuple[int, int]:
    """The fc forward kernel's tile: (rows, cols), at most 16 batch rows
    and 16 of fc1's D1 output columns.  Its grid is (ceil(D1 / cols),
    ceil(B / rows), K): the paper's cohort (K=10, B=10, D1=128) gives 80
    blocks, the eval (K=1, B=1000) 504, one user 8.  The tiling changes
    no bit of the result: every sum runs over its input in order."""
    del k
    return min(bs, FC_FWD_MAX_ROWS), min(d1, FC_FWD_MAX_COLS)


# per (device, stream): the counters of the fc forward (one per row tile)
# and of the conv backward (one per user), which each kernel leaves at 0;
# a buffer of its own per stream, so that launches on two streams never
# share one (launches on one stream run one after another)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _fc_chain_fwd(flat, params, user: bool):
    dt, k, bs, f, d1, d2, d3 = _fc_dims(flat, params)
    new = lambda *s: torch.empty(s, dtype=dt, device=flat.device)
    logits, h1, h2 = new(k, bs, d3), new(k, bs, d1), new(k, bs, d2)
    rows, cols = fc_fwd_tiling(k, bs, d1)
    with torch.cuda.device(flat.device):
        counters = _counters(flat.device, k * -(-bs // rows))
        _launch(user, "fc_chain_fwd", "fcnn_fc_fwd",
                [flat.data_ptr()] + [t.data_ptr() for t in _fc_tensors(params)]
                + [logits.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                   counters.data_ptr()], k,
                [bs, f, d1, d2, d3, rows, cols, int(dt == torch.bfloat16)])
    return logits, (h1, h2)


def fc_chain_fwd_k(flat: torch.Tensor, params: dict) -> Tuple:
    """flat (K,B,F), stacked fc params -> logits (K,B,D3), (h1, h2)."""
    if _build.on_cpu(flat, *_fc_tensors(params)):
        return ref.fc_chain_fwd_k(flat, params)
    return _fc_chain_fwd(flat, params, user=False)


def fc_chain_fwd(flat: torch.Tensor, params: dict) -> Tuple:
    """One user: flat (B,F), fc params -> logits (B,D3), (h1, h2)."""
    if _build.on_cpu(flat, *_fc_tensors(params)):
        return ref.fc_chain_fwd(flat, params)
    logits, (h1, h2) = _fc_chain_fwd(_one(flat), _lead(params), user=True)
    return logits[0], (h1[0], h2[0])


def _fc_chain_bwd(flat, res, params, dlogits, user: bool):
    h1, h2 = res
    dt, k, bs, f, d1, d2, d3 = _fc_dims(flat, params)
    _build.check("h1", h1, (k, bs, d1), dt)
    _build.check("h2", h2, (k, bs, d2), dt)
    _build.check("dlogits", dlogits, (k, bs, d3), dt)
    # the kernel copies whole 4-byte words and gives a thread to a column
    if max(d1, d2, d3) > 256 or (f | d1 | d2 | d3) % 2:
        raise ValueError(f"fc_chain_bwd: widths {(f, d1, d2, d3)} must be "
                         "even and the layers' at most 256")
    for name, t in (("flat", flat), ("h1", h1), ("h2", h2),
                    ("dlogits", dlogits), *((f"{n}.w", params[n]["w"])
                                            for n in ("fc1", "fc2", "fc3"))):
        _build.check(name, t, t.shape, dt, align=4)
    new = lambda d, *s: torch.empty(s, dtype=d, device=flat.device)
    g1 = {"w": new(f32, k, f, d1), "b": new(f32, k, d1)}
    g2 = {"w": new(f32, k, d1, d2), "b": new(f32, k, d2)}
    g3 = {"w": new(f32, k, d2, d3), "b": new(f32, k, d3)}
    dflat = new(dt, k, bs, f)
    p1, p2, p3 = params["fc1"], params["fc2"], params["fc3"]
    with torch.cuda.device(flat.device):
        _launch(user, "fc_chain_bwd", "fcnn_fc_bwd",
                [flat.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                 dlogits.data_ptr(), p1["w"].data_ptr(), p2["w"].data_ptr(),
                 p3["w"].data_ptr(), g1["w"].data_ptr(), g1["b"].data_ptr(),
                 g2["w"].data_ptr(), g2["b"].data_ptr(), g3["w"].data_ptr(),
                 g3["b"].data_ptr(), dflat.data_ptr()], k,
                [bs, f, d1, d2, d3, int(dt == torch.bfloat16)])
    return {"fc1": g1, "fc2": g2, "fc3": g3}, dflat


def fc_chain_bwd_k(flat: torch.Tensor, res: Tuple, params: dict,
                   dlogits: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """Per-user fc grads {fc1,fc2,fc3: {w, b}} (f32) and dflat (K,B,F)."""
    if _build.on_cpu(flat, *res, dlogits, *_fc_tensors(params)):
        return ref.fc_chain_bwd_k(flat, res, params, dlogits)
    return _fc_chain_bwd(flat, res, params, dlogits, user=False)


def fc_chain_bwd(flat: torch.Tensor, res: Tuple, params: dict,
                 dlogits: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """One user's fc grads (f32) and dflat (B,F)."""
    if _build.on_cpu(flat, *res, dlogits, *_fc_tensors(params)):
        return ref.fc_chain_bwd(flat, res, params, dlogits)
    grads, dflat = _fc_chain_bwd(_one(flat), tuple(_one(r) for r in res),
                                 _lead(params), _one(dlogits), user=True)
    return ({n: {leaf: t[0] for leaf, t in g.items()}
             for n, g in grads.items()}, dflat[0])
