"""The paper's model: 5-layer MNIST CNN (2 conv + 3 fc), Section IV
(``repro/models/cnn.py``).

Layouts are the reference's: NHWC images, HWIO conv weights (3, 3, Cin,
Cout), (in, out) dense weights, so param trees move between the packages
with no transposes.  Stages [conv1, conv2, fc1, fc2, fc3]; SL cuts at a
stage boundary.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import module as m

STAGES = ("conv1", "conv2", "fc1", "fc2", "fc3")
NUM_STAGES = len(STAGES)


def init_cnn(seed: int = 0, device=None, num_classes: int = 10,
             image_side: int = 28) -> Dict:
    """Random init from ``torch.Generator().manual_seed(seed)``, on
    ``device`` (``None``: the CUDA card, see ``repro_torch.device``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    side = image_side // 4                        # two 2x2 pools
    flat = side * side * 16
    return {
        "conv1": {"w": m.normal(gen, (3, 3, 1, 8), 9 ** -0.5, device),
                  "b": m.zeros((8,), device)},
        "conv2": {"w": m.normal(gen, (3, 3, 8, 16), 72 ** -0.5, device),
                  "b": m.zeros((16,), device)},
        "fc1": {"w": m.dense_init(gen, flat, 128, device),
                "b": m.zeros((128,), device)},
        "fc2": {"w": m.dense_init(gen, 128, 64, device),
                "b": m.zeros((64,), device)},
        "fc3": {"w": m.dense_init(gen, 64, num_classes, device),
                "b": m.zeros((num_classes,), device)},
    }


def _patches3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9·C) SAME-padded 3x3 patch view, taps in
    (i, j, c) order: the contraction order of the HWIO weight."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(3) for j in range(3)]
    return torch.cat(cols, dim=-1)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool via reshape."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _conv_im2col(p, x):
    b, h, w, cin = x.shape
    cout = p["w"].shape[-1]
    y = _patches3x3(x).reshape(b * h * w, 9 * cin)
    y = y @ p["w"].reshape(9 * cin, cout)
    y = torch.relu(y.reshape(b, h, w, cout) + p["b"])
    return _pool2(y)


def _fc(p, x, act=True):
    y = x @ p["w"] + p["b"]
    return torch.relu(y) if act else y


def forward_im2col(params, images: torch.Tensor) -> torch.Tensor:
    """Full-model forward in plain torch (differentiable by autograd):
    convolutions as (B·H·W, 9·Cin)x(9·Cin, Cout) matmuls, pooling as a
    reshape-max."""
    y = _conv_im2col(params["conv1"], images)
    y = _conv_im2col(params["conv2"], y)
    y = y.reshape(y.shape[0], -1)
    y = _fc(params["fc1"], y)
    y = _fc(params["fc2"], y)
    return _fc(params["fc3"], y, act=False)


def forward_im2col_k(params, images: torch.Tensor) -> torch.Tensor:
    """Stacked-cohort forward: params leaves (K, ...), images
    (K, B, H, W, C) -> logits (K, B, classes)."""
    return torch.stack([
        forward_im2col({s: {n: t[k] for n, t in params[s].items()}
                        for s in params}, images[k])
        for k in range(images.shape[0])])


def split_params(params, cut: int) -> Tuple[Dict, Dict]:
    """UE-side stages [0, cut), BS-side stages [cut, 5)."""
    ue = {s: params[s] for s in STAGES[:cut]}
    bs = {s: params[s] for s in STAGES[cut:]}
    return ue, bs


def merge_params(ue: Dict, bs: Dict) -> Dict:
    return {**ue, **bs}
