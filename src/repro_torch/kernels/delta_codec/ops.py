"""Tree-level delta codec: parameter snapshots as int8 deltas
(``repro/kernels/delta_codec/ops.py``).

``encode_delta(params, base)`` quantizes ``params - base`` through the
``quantize_blocks`` kernel; ``decode_delta`` returns base + the
dequantized delta.  ``codec_ratio(n)`` is the exact wire-byte ratio of an
n-value payload (``ceil(n/block)`` quantized blocks packed to the bit
depth, plus one f32 scale each, over n f32 values); ``COMPRESS_RATIO`` is
its int8 asymptote.

The flat views are the reference's element for element: leaves are
concatenated in ``utils/tree.tree_leaves`` order (sorted keys, the order
of ``jax.tree_util``) with their own layouts (HWIO, (in, out)), padded to
``block`` lanes and, past one tile, to a multiple of ``TILE_ROWS`` rows.
Stacked ``(K, ...)`` cohorts always pad every user to a multiple of
``TILE_ROWS`` rows (the paper CNN: 217 rows of 512 -> 256).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.delta_codec.kernel import (BLOCK, TILE_ROWS,
                                                    dequantize_blocks,
                                                    quantize_blocks,
                                                    validate_bits,
                                                    validate_block)
from repro_torch.utils.tree import tree_leaves, tree_map

COMPRESS_RATIO = (1.0 + 4.0 / BLOCK) / 4.0     # ≈ 0.2520 of f32 bytes (int8)


def _padded_rows(n: int, block: int = BLOCK) -> int:
    """Rows of the (M, block) view for n values, honouring the row tiling."""
    rows = max(1, math.ceil(n / block))
    if rows > TILE_ROWS:
        rows = math.ceil(rows / TILE_ROWS) * TILE_ROWS
    return rows


def _refill(flat: torch.Tensor, like: Any, lead: Tuple[int, ...]) -> Any:
    """Cut the (*lead, n) ``flat`` back into the leaves of ``like``."""
    off = [0]

    def take(leaf):
        size = leaf.numel() // max(1, math.prod(lead))
        out = flat[..., off[0]:off[0] + size].reshape(leaf.shape)
        off[0] += size
        return out.to(leaf.dtype)

    return tree_map(take, like)


def _flatten(tree: Any, block: int = BLOCK) -> Tuple[torch.Tensor, int]:
    """Tree -> ((M, block) f32 view, n real values)."""
    flat = torch.cat([leaf.reshape(-1).float() for leaf in tree_leaves(tree)])
    n = flat.numel()
    rows = _padded_rows(n, block)
    flat = torch.nn.functional.pad(flat, (0, rows * block - n))
    return flat.reshape(rows, block), n


def _unflatten(flat: torch.Tensor, like: Any) -> Any:
    return _refill(flat.reshape(-1), like, ())


def stacked_flatten(stacked: Any, block: int = BLOCK
                    ) -> Tuple[torch.Tensor, int]:
    """Stacked user tree (leaves ``(K, ...)``) -> ``(K, M, block)`` + n.

    M is padded to a multiple of TILE_ROWS, as in the reference, so the
    collapsed ``(K·M, block)`` view is the reference's for any K."""
    validate_block(block)
    leaves = tree_leaves(stacked)
    k = leaves[0].shape[0]
    flat = torch.cat([leaf.reshape(k, -1).float() for leaf in leaves], dim=1)
    n = flat.shape[1]
    rows = math.ceil(max(1, math.ceil(n / block)) / TILE_ROWS) * TILE_ROWS
    flat = torch.nn.functional.pad(flat, (0, rows * block - n))
    return flat.reshape(k, rows, block), n


def stacked_unflatten(flat: torch.Tensor, like_stacked: Any) -> Any:
    """Inverse of ``stacked_flatten`` (drops the padding)."""
    k = flat.shape[0]
    return _refill(flat.reshape(k, -1), like_stacked, (k,))


def encode_delta(params: Any, base: Any, block: int = BLOCK,
                 bits: int = 8) -> Dict[str, Any]:
    """Quantize ``params - base``: ``{"q", "scales", "n", "bits"}``."""
    delta = tree_map(lambda p, b: p - b, params, base)
    flat, n = _flatten(delta, block)
    q, s = quantize_blocks(flat, bits=bits)
    return {"q": q, "scales": s, "n": n, "bits": bits}


def decode_delta(payload: Dict[str, Any], base: Any) -> Any:
    """base + the dequantized delta of ``payload``."""
    flat = dequantize_blocks(payload["q"], payload["scales"])
    return tree_map(lambda b, d: b + d, base, _unflatten(flat, base))


def payload_bytes(payload: Dict[str, Any]) -> int:
    """True wire bytes: the real blocks' lanes packed to the bit depth, plus
    one f32 scale each (row padding is not transmitted)."""
    block = payload["q"].shape[-1]
    bits = int(payload.get("bits", 8))
    blocks = math.ceil(int(payload["n"]) / block)
    return blocks * block * bits // 8 + blocks * 4


def codec_ratio(n: int, block: int = BLOCK, bits: int = 8) -> float:
    """Exact compressed/uncompressed byte ratio of an n-value payload."""
    blocks = math.ceil(n / validate_block(block))
    return (blocks * block * validate_bits(bits) / 8.0 + blocks * 4) \
        / (4.0 * n)
