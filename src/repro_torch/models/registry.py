"""Model registry: resolve an arch id to a uniform model API
(``repro/models/registry.py``).

``build_model(cfg, device=None)`` binds a config to a device (``None``:
the CUDA card, which raises without one; ``"cpu"`` runs the kernels'
twins).  ``Model.init(gen)`` draws params from a ``torch.Generator`` on
the generator's device and places them on the model's.  Every family of
the zoo is served; an encoder-only config (hubert-xlarge) has no decode.
``abstract_init(cfg)`` is the port's ``jax.eval_shape(model.init)``: the
param tree as meta tensors, its paths, shapes and dtypes, with no draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import module as m
from repro_torch.models import transformer as tf


@dataclass(frozen=True)
class Model:
    """Uniform handle: init/apply callables bound to one config and device."""
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Dict[str, Any]]
    forward: Callable[..., Any]            # (params, inputs, opts) -> (logits, aux)
    decode: Optional[Callable[..., Any]]   # (params, token, state, position, opts)
    init_decode_state: Optional[Callable[..., Any]]

    def param_count(self, params) -> int:
        return m.param_count(params)


def abstract_init(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree of ``cfg`` as ``meta`` tensors: ``Model.init``'s
    paths, shapes and dtypes, with nothing drawn or allocated (so
    llama3-405b's and llama4-maverick's trees cost nothing)."""
    if cfg.family == "cnn":
        raise ValueError("abstract_init covers the transformer zoo, not the "
                         "paper's CNN")
    return tf.init_model(None, cfg, "meta")


def build_model(cfg: ModelConfig, device=None) -> Model:
    dev = resolve_device(device)
    if cfg.family == "cnn":
        return Model(
            cfg=cfg, device=dev,
            init=lambda gen: cnn_mod.init_cnn(gen.initial_seed(), dev,
                                              cfg.vocab_size, cfg.d_model),
            forward=lambda p, inputs, opts=None: (
                cnn_mod.forward(p, inputs["images"]), 0.0),
            decode=None,
            init_decode_state=None,
        )
    has_decode = not cfg.is_encoder_only
    return Model(
        cfg=cfg, device=dev,
        init=lambda gen: tf.init_model(gen, cfg, dev),
        forward=lambda p, inputs, opts=None: tf.forward_full(p, cfg, inputs,
                                                             opts),
        decode=(lambda p, token, state, position, opts=None:
                tf.decode_step(p, cfg, token, state, position, opts)
                ) if has_decode else None,
        init_decode_state=(lambda batch, context_len, dtype:
                           tf.init_decode_state(cfg, batch, context_len,
                                                dtype, dev)
                           ) if has_decode else None,
    )

