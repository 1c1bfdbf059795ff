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


def param_shapes(num_classes: int = 10, image_side: int = 28) -> Dict:
    """The params tree's leaf shapes, with no tensor made."""
    flat = (image_side // 4) ** 2 * 16            # two 2x2 pools
    return {"conv1": {"w": (3, 3, 1, 8), "b": (8,)},
            "conv2": {"w": (3, 3, 8, 16), "b": (16,)},
            "fc1": {"w": (flat, 128), "b": (128,)},
            "fc2": {"w": (128, 64), "b": (64,)},
            "fc3": {"w": (64, num_classes), "b": (num_classes,)}}


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


def _pool2_first(y: torch.Tensor) -> torch.Tensor:
    """2x2 max pool over (..., H, W, C) whose gradient goes to the first
    maximum of each window in row-major order, as the gradient of JAX's
    ``reduce_window`` max does (select-and-scatter with ``>=``): the window
    is gathered at its first argmax, and the gather's backward scatters the
    whole cotangent there.  ``amax`` would split it among tied maxima."""
    *lead, h, w, c = y.shape
    n = len(lead)
    win = y.reshape(*lead, h // 2, 2, w // 2, 2, c).permute(
        *range(n), n, n + 2, n + 4, n + 1, n + 3).reshape(
            *lead, h // 2, w // 2, c, 4)
    first = torch.argmax(win, dim=-1, keepdim=True)
    return torch.gather(win, -1, first).squeeze(-1)


def _conv(p, x, pool):
    """3x3 SAME conv as an im2col matmul, bias, ReLU and ``pool`` over
    (..., B, H, W, C); with stacked params (leaves (K, ...)) the leading
    axis is the user and the product a batched matmul per user."""
    *lead, h, w, cin = x.shape
    cout = p["w"].shape[-1]
    pat = _patches3x3(x.reshape(-1, h, w, cin))
    pat = pat.reshape(*lead[:-1], lead[-1] * h * w, 9 * cin)
    z = pat @ p["w"].reshape(*p["w"].shape[:-4], 9 * cin, cout)
    b = p["b"].reshape(*p["b"].shape[:-1], 1, 1, 1, cout)
    return pool(torch.relu(z.reshape(*lead, h, w, cout) + b))


def _fc(p, x, act=True):
    y = x @ p["w"] + p["b"].unsqueeze(-2)
    return torch.relu(y) if act else y


def forward(params, images: torch.Tensor) -> torch.Tensor:
    """The model of ``repro/models/cnn.forward``, differentiable by
    autograd, for the host engine: images (B, 28, 28, 1) -> logits
    (B, classes), or with stacked params (leaves (K, ...)) images
    (K, B, 28, 28, 1) -> (K, B, classes).

    JAX's forward is ``conv_general_dilated`` + ``reduce_window`` max; here
    the conv is the im2col matmul (equal up to summation order) and the
    pool routes its gradient to the first maximum (``_pool2_first``)."""
    y = _conv(params["conv1"], images, _pool2_first)
    y = _conv(params["conv2"], y, _pool2_first)
    y = y.reshape(*y.shape[:-3], -1)
    y = _fc(params["fc1"], y)
    y = _fc(params["fc2"], y)
    return _fc(params["fc3"], y, act=False)


def forward_im2col(params, images: torch.Tensor,
                   compute_dtype=None) -> torch.Tensor:
    """Full-model forward in plain torch (differentiable by autograd):
    convolutions as (B·H·W, 9·Cin)x(9·Cin, Cout) matmuls, pooling as a
    reshape-max whose gradient splits evenly among tied maxima (JAX's rule
    for ``max``, which the reference's reshape-max pool follows).

    ``compute_dtype`` (bf16 under the mixed-precision policy) casts params
    and images to it, so every product and activation runs in it, and the
    logits come back f32; ``None`` keeps the params' dtype."""
    if compute_dtype is not None:
        params = {s: {n: t.to(compute_dtype) for n, t in params[s].items()}
                  for s in params}
        images = images.to(compute_dtype)
    y = _conv(params["conv1"], images, _pool2)
    y = _conv(params["conv2"], y, _pool2)
    y = y.reshape(y.shape[0], -1)
    y = _fc(params["fc1"], y)
    y = _fc(params["fc2"], y)
    y = _fc(params["fc3"], y, act=False)
    if compute_dtype is None:
        return y
    return y.float()  # analysis: ok=dtype-thread (f32 logits by contract)


def forward_im2col_k(params, images: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """Stacked-cohort forward: params leaves (K, ...), images
    (K, B, H, W, C) -> logits (K, B, classes), one user at a time."""
    return torch.stack([
        forward_im2col({s: {n: t[k] for n, t in params[s].items()}
                        for s in params}, images[k], compute_dtype)
        for k in range(images.shape[0])])


def split_params(params, cut: int) -> Tuple[Dict, Dict]:
    """UE-side stages [0, cut), BS-side stages [cut, 5)."""
    ue = {s: params[s] for s in STAGES[:cut]}
    bs = {s: params[s] for s in STAGES[cut:]}
    return ue, bs


def merge_params(ue: Dict, bs: Dict) -> Dict:
    return {**ue, **bs}
