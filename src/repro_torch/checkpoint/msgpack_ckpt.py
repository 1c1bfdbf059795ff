"""Checkpoints as msgpack-serialized trees with a dtype/shape manifest
(``repro/checkpoint/msgpack_ckpt.py``), on the same on-disk format.

Layout: ``<dir>/<step>/checkpoint.msgpack + MANIFEST.json [+ aux.json]``
and a ``COMMIT`` marker written last; ``latest_step`` resolves the newest
*committed* save, so a crashed writer is skipped.  The payload is a
msgpack array with one map per leaf, ``{"dtype", "shape", "data"}``, the
leaves in ``jax.tree_util`` order (dict keys sorted, lists and tuples in
order), so a checkpoint written by either package restores in the other.
``MANIFEST.json``'s ``treedef`` string is informational; neither package
reads it back.

The card's machine has no ``msgpack`` package, so this module carries its
own encoder and decoder (``packb``/``unpackb``) for the subset that the
checkpoint and the serving wire use: maps, arrays, str, bin, ints, floats,
bool and nil.  ``packb`` gives the bytes of
``msgpack.packb(obj, use_bin_type=True)`` byte for byte (smallest
encodings, maps in insertion order): the serving path's payload lengths set
the transport's chunk counts, and CRCs cover them.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten

# ---------------------------------------------------------------------------
# msgpack, the subset the checkpoint and the wire use
# ---------------------------------------------------------------------------


def _header(out: bytearray, n: int, small: int, small_max: int,
            codes) -> None:
    """A length header: the fix form ``small | n`` below ``small_max``,
    else the first of ``codes`` ((code, struct format, limit), ...) that
    holds n."""
    if small is not None and n < small_max:
        out.append(small | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(o: int, out: bytearray) -> None:
    if o < -(1 << 5):
        for code, fmt, lo in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                              (0xd2, ">i", -(1 << 31)),
                              (0xd3, ">q", -(1 << 63))):
            if o >= lo:
                out.append(code)
                out += struct.pack(fmt, o)
                return
        raise OverflowError(f"msgpack: int {o} too small")
    if o < (1 << 7):
        out += struct.pack(">b", o) if o < 0 else bytes([o])
        return
    for code, fmt, hi in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                          (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
        if o < hi:
            out.append(code)
            out += struct.pack(fmt, o)
            return
    raise OverflowError(f"msgpack: int {o} too large")


def _pack(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xc0)
    elif o is True or o is False:
        out.append(0xc3 if o else 0xc2)
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out.append(0xcb)
        out += struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _header(out, len(b), 0xa0, 32, ((0xd9, ">B", 1 << 8),
                                        (0xda, ">H", 1 << 16),
                                        (0xdb, ">I", 1 << 32)))
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        _header(out, len(b), None, 0, ((0xc4, ">B", 1 << 8),
                                       (0xc5, ">H", 1 << 16),
                                       (0xc6, ">I", 1 << 32)))
        out += b
    elif isinstance(o, (list, tuple)):
        _header(out, len(o), 0x90, 16, ((0xdc, ">H", 1 << 16),
                                        (0xdd, ">I", 1 << 32)))
        for x in o:
            _pack(x, out)
    elif isinstance(o, dict):
        _header(out, len(o), 0x80, 16, ((0xde, ">H", 1 << 16),
                                        (0xdf, ">I", 1 << 32)))
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(o).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported types."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.num(">B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.obj() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), "utf-8")
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in _FIXED:
            return self.num(_FIXED[c])
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.num(_LEN[1 << (c - 0xc4)])))
        if c in (0xd9, 0xda, 0xdb):
            return str(self.take(self.num(_LEN[1 << (c - 0xd9)])), "utf-8")
        if c in (0xdc, 0xdd):
            return [self.obj() for _ in range(self.num(_LEN[2 if c == 0xdc
                                                             else 4]))]
        if c in (0xde, 0xdf):
            return self.map(self.num(_LEN[2 if c == 0xde else 4]))
        raise ValueError(f"msgpack: unsupported type byte {c:#04x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the supported types."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes of extra "
                         f"data")
    return obj


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _treedef(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    return "None" if tree is None else "*"


def _encode_leaf(x) -> Dict[str, Any]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        x = t.numpy()
    arr = np.asarray(x)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode_leaf(d: Dict[str, Any]):
    """numpy array (a writable copy), or a bfloat16 tensor (numpy has no
    bfloat16)."""
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], np.int16).reshape(d["shape"]).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    return np.frombuffer(d["data"], np.dtype(d["dtype"])) \
        .reshape(d["shape"]).copy()


def as_like(arr, ref):
    """A decoded leaf in the kind of ``ref``: a tensor on ref's device, or
    numpy."""
    if isinstance(ref, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(ref.device)
    return arr


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    aux: Optional[Dict[str, Any]] = None) -> str:
    """Write step ``step``; only the final COMMIT marker makes it visible.
    ``aux`` is a JSON sidecar committed with the tensor payload."""
    leaves = tree_leaves(tree)
    path = os.path.join(ckpt_dir, str(step))
    os.makedirs(path, exist_ok=True)
    enc = [_encode_leaf(x) for x in leaves]
    tmp = os.path.join(path, "checkpoint.msgpack.tmp")
    with open(tmp, "wb") as f:
        f.write(packb(enc))
    os.replace(tmp, os.path.join(path, "checkpoint.msgpack"))
    with open(os.path.join(path, "MANIFEST.json"), "w") as f:
        json.dump({"step": step, "num_leaves": len(leaves),
                   "treedef": _treedef(tree),
                   "leaves": [{"dtype": d["dtype"], "shape": d["shape"]}
                              for d in enc]}, f)
    if aux is not None:
        with open(os.path.join(path, "aux.json"), "w") as f:
            json.dump(aux, f)
    open(os.path.join(path, "COMMIT"), "w").close()
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step, or None; uncommitted step directories and
    stray files are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))
             and os.path.exists(os.path.join(ckpt_dir, d, "COMMIT"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: tensor leaves of ``like``
    come back as tensors on their device, numpy leaves as numpy.  Each
    leaf is checked against ``MANIFEST.json`` and against ``like``."""
    path = os.path.join(ckpt_dir, str(step))
    with open(os.path.join(path, "checkpoint.msgpack"), "rb") as f:
        enc = unpackb(f.read())
    refs = tree_leaves(like)
    if len(enc) != len(refs):
        raise ValueError(f"checkpoint has {len(enc)} leaves, expected "
                         f"{len(refs)}")
    specs: List[Optional[Dict[str, Any]]] = [None] * len(enc)
    mpath = os.path.join(path, "MANIFEST.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
        if "leaves" in manifest:
            if len(manifest["leaves"]) != len(enc):
                raise ValueError(
                    f"MANIFEST.json records {len(manifest['leaves'])} leaves "
                    f"but the payload holds {len(enc)}: the save is "
                    f"inconsistent (corrupt or mixed-version)")
            specs = list(manifest["leaves"])
    out = []
    for i, (d, ref, spec) in enumerate(zip(enc, refs, specs)):
        arr = _decode_leaf(d)
        if spec is not None and (list(arr.shape) != list(spec["shape"])
                                 or d["dtype"] != spec["dtype"]):
            raise ValueError(
                f"leaf {i}: decoded {d['dtype']}{tuple(arr.shape)} does not "
                f"match MANIFEST.json {spec['dtype']}{tuple(spec['shape'])}: "
                f"the checkpoint payload is corrupt")
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: shape mismatch {tuple(arr.shape)} "
                             f"vs {tuple(np.shape(ref))}")
        out.append(as_like(arr, ref))
    return tree_unflatten(like, iter(out))


def restore_aux(ckpt_dir: str, step: int) -> Optional[Dict[str, Any]]:
    """The JSON sidecar saved with step ``step`` (None if absent)."""
    path = os.path.join(ckpt_dir, str(step), "aux.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
