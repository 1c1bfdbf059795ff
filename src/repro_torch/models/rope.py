"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE
(``repro/models/rope.py``).

M-RoPE [arXiv:2409.12191]: the head_dim/2 rotary frequencies are split into
(t, h, w) sections; each section reads its position id from the matching row
of a (B, 3, S) position tensor.  For pure text, t == h == w == arange(S).
Angles are f32; cos and sin are cast to x's dtype before the rotation, as
in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """Angles (..., S, head_dim/2) from positions.

    positions: (B, S) int for standard RoPE, or (B, 3, S) for M-RoPE.
    """
    inv = rope_freqs(head_dim, theta, positions.device)       # (half,)
    if not mrope_sections:
        if positions.dim() == 3:                              # tolerate (B,3,S)
            positions = positions[:, 0]
        return positions[..., None].to(torch.float32) * inv
    assert positions.dim() == 3 and positions.shape[1] == 3, (
        "M-RoPE needs (B, 3, S) positions")
    half = head_dim // 2
    assert sum(mrope_sections) == half, (mrope_sections, half)
    # angle per (section row, freq): pick t/h/w position per frequency band
    # (the band index from two comparisons: no host data reaches the card)
    f = torch.arange(half, device=positions.device)
    t, h = mrope_sections[0], mrope_sections[0] + mrope_sections[1]
    sec_id = (f >= t).long() + (f >= h).long()                    # (half,)
    b, _, s = positions.shape
    pos = torch.gather(positions.to(torch.float32), 1,
                       sec_id[None, :, None].expand(b, half, s))  # (B,half,S)
    return pos.transpose(1, 2) * inv                              # (B,S,half)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, D) by angles (..., S, D/2) (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)        # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def text_positions(batch: int, seq: int, mrope: bool = False,
                   offset: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """Default positions; offset (B,) shifts (decode).  Returns (B,S) or (B,3,S)."""
    pos = torch.arange(seq, dtype=torch.int32,
                       device=device)[None].expand(batch, seq)
    if offset is not None:
        pos = pos + offset[:, None].to(torch.int32)
    if mrope:
        pos = pos[:, None].expand(batch, 3, seq)
    return pos
