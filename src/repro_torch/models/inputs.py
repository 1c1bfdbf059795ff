"""Input trees per (architecture x input shape), in two renderings
(``repro/models/inputs.py``):

- ``input_specs``: ``(shape, dtype)`` pairs, the structure a step takes;
- ``materialize``: real tensors of that structure.

This is where the modality-frontend stub lives: audio gets precomputed
frame embeddings (B, S, d); vlm gets patch embeddings (B, P, d) and M-RoPE
positions (B, 3, S).  ``materialize`` draws from
``np.random.default_rng(seed)`` in the reference's order, so one seed gives
both packages the same tokens, frames, patch embeddings and positions.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import module as m

Spec = Tuple[Tuple[int, ...], torch.dtype]


def train_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Spec]:
    dt = m.dtype_of(cfg.dtype)
    if cfg.family == "audio":
        return {
            "embeds": ((B, S, cfg.d_model), dt),
            "labels": ((B, S), torch.int32),
            "mask": ((B, S), torch.bool),
        }
    spec = {
        "tokens": ((B, S), torch.int32),
        "labels": ((B, S), torch.int32),
    }
    if cfg.family == "vlm":
        spec["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model), dt)
        spec["positions"] = ((B, 3, S), torch.int32)
    return spec


def prefill_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Spec]:
    spec = train_specs(cfg, B, S)
    spec.pop("labels", None)
    spec.pop("mask", None)
    return spec


def decode_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Spec]:
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode")
    return {
        "token": ((B, 1), torch.int32),
        "position": ((B,), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Spec]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return train_specs(cfg, B, S)
    if shape.kind == "prefill":
        return prefill_specs(cfg, B, S)
    return decode_specs(cfg, B, S)


def materialize(spec: Dict[str, Spec], cfg: ModelConfig, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Tensors for ``spec`` on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, (shape, dtype) in spec.items():
        if name in ("tokens", "labels", "token"):
            a = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        elif name == "position":
            a = np.zeros(shape, np.int32)
        elif name == "positions":
            B, _, S = shape
            a = np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S))
        elif name == "mask":
            a = rng.random(shape) < 0.3
        else:  # embeds / patch_embeds: f64 -> f32 -> dtype
            a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=dtype)
    return out
