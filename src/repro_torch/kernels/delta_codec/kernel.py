"""Wrappers of the two delta-codec CUDA kernels (``csrc/delta_codec.cu``).

Counterparts of ``quantize_blocks`` and ``dequantize_blocks`` of
``repro/kernels/delta_codec/kernel.py``: blockwise absmax quantization of
a ``(M, block)`` f32 view to int8 (``bits=8``, values clipped to ±127) or
to int4 values stored in int8 lanes (``bits=4``, ±7; nothing is packed),
with one f32 scale per row.  On CPU tensors a wrapper runs the plain twin
of ``ref.py``; on CUDA tensors it checks dtype, shape, contiguity and
alignment, allocates its outputs with ``torch.empty``, launches on the
current stream and raises on a launch error.  There is no fallback from
the card to the twin.

``LAUNCHES`` counts the kernel launches of each wrapper.  The TPU kernels
tile the rows in grid steps of ``TILE_ROWS``; the CUDA kernels take any
row count, and ``ops`` pads rows exactly as the reference does so that the
``(M, block)`` views agree element for element.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.delta_codec import ref

BLOCK = 512          # default lanes per quantization group
TILE_ROWS = 256      # the reference's rows per grid step (row padding unit)
BITS = (4, 8)        # supported quantization bit depths

LAUNCHES: Dict[str, int] = {"quantize_blocks": 0, "dequantize_blocks": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types before the stream
_LIB = _build.Library("delta_codec", {
    "dcodec_quantize": [_P, _P, _P, _I, _I, _I],
    "dcodec_dequantize": [_P, _P, _P, _I, _I],
}, "dcodec_error_string", LAUNCHES)
reset_launches = _LIB.reset


def validate_block(block: int) -> int:
    """A quantization group width must be a positive multiple of 128 (the
    TPU lane count, kept so that ``codec_ratio`` agrees with the
    reference)."""
    if block <= 0 or block % 128:
        raise ValueError(
            f"codec block width must be a positive multiple of 128 "
            f"(TPU lane alignment), got {block}")
    return block


def validate_bits(bits: int) -> int:
    """``HSFLConfig.codec_bits`` must be a supported depth."""
    if bits not in BITS:
        raise ValueError(f"codec bit depth must be one of {BITS}, "
                         f"got {bits}")
    return bits


def quantize_blocks(x: torch.Tensor, bits: int = 8):
    """x (M, block) f32 -> (q int8 (M, block), scales f32 (M, 1))."""
    if x.dim() != 2:
        raise ValueError(f"quantize_blocks: expected (M, block), got "
                         f"{tuple(x.shape)}")
    m, blk = x.shape
    validate_block(blk)
    validate_bits(bits)
    if _build.on_cpu(x):
        return ref.quantize_ref(x, bits)
    _build.check("x", x, (m, blk), align=16)
    if m < 1:
        raise ValueError("quantize_blocks: no rows")
    q = torch.empty((m, blk), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _LIB.launch("quantize_blocks", "dcodec_quantize", x.data_ptr(),
                     q.data_ptr(), s.data_ptr(), m, blk, 2 ** (bits - 1) - 1)
    return q, s


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q (M, block) int8, scales (M, 1) f32 -> (M, block) f32."""
    if q.dim() != 2:
        raise ValueError(f"dequantize_blocks: expected (M, block), got "
                         f"{tuple(q.shape)}")
    m, blk = q.shape
    if _build.on_cpu(q, scales):
        return ref.dequantize_ref(q, scales)
    _build.check("q", q, (m, blk), torch.int8, align=16)
    _build.check("scales", scales, (m, 1))
    if m < 1 or blk % 4:
        raise ValueError(f"dequantize_blocks: bad shape {(m, blk)}")
    out = torch.empty((m, blk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _LIB.launch("dequantize_blocks", "dcodec_dequantize", q.data_ptr(),
                     scales.data_ptr(), out.data_ptr(), m, blk)
    return out
