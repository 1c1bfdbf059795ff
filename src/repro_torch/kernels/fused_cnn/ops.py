"""The CNN training step and eval forward around the fused-CNN kernels
(``repro/kernels/fused_cnn/ops.py``).

The port has one training path: the four kernels of ``kernel.py``, which
launch CUDA kernels on CUDA tensors and run their plain twins on CPU
tensors.  ``ForwardPolicy`` keeps the reference's fields so a JAX config
carries over: ``kernel="xla"`` and ``kernel="pallas"`` name the same
algorithm in the reference (pinned equal there) and both run this path.
``block_k`` is validated and has no effect: the CUDA kernels choose their
own tiling.  Everything between the kernels (the softmax cross-entropy
cotangent, the SGD update) is plain torch, as the reference leaves it to
XLA outside its kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.fused_cnn import kernel as knl
from repro_torch.utils.tree import tree_leaves, tree_map

KERNELS = ("xla", "pallas", "im2col")
PRECISIONS = ("f32", "bf16")


@dataclass(frozen=True)
class ForwardPolicy:
    """How the CNN hot path computes (same fields as the reference)."""
    kernel: str = "xla"
    precision: str = "f32"
    interpret: bool = False
    block_k: int = 0
    batch_users: bool = True

    def validate(self) -> "ForwardPolicy":
        if self.kernel not in KERNELS:
            raise ValueError(f"ForwardPolicy.kernel={self.kernel!r}; "
                             f"choose from {KERNELS}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"ForwardPolicy.precision={self.precision!r}; "
                             f"choose from {PRECISIONS}")
        if not isinstance(self.block_k, int) or self.block_k < 0:
            raise ValueError(f"ForwardPolicy.block_k={self.block_k!r}; "
                             "expected an int >= 0 (0 = whole cohort)")
        if self.kernel == "im2col":
            raise NotImplementedError(
                "kernel='im2col' (the autodiff baseline) is not ported yet "
                "(ROADMAP queue 1: model and loss)")
        if self.precision == "bf16":
            raise NotImplementedError(
                "precision='bf16' is not ported yet (ROADMAP queue 1: bf16 "
                "and the single-user kernels)")
        if not self.batch_users:
            raise NotImplementedError(
                "batch_users=False (the single-user kernels) is not ported "
                "yet (ROADMAP queue 1: bf16 and the single-user kernels)")
        return self


def forward_fwd_k(params: dict, images: torch.Tensor):
    """Stacked-cohort forward + residuals through the kernels: params
    leaves (K, ...), images (K, B, H, W, C)."""
    a1, r1 = knl.conv_pool_fwd_k(images, params["conv1"]["w"],
                                 params["conv1"]["b"])
    a2, r2 = knl.conv_pool_fwd_k(a1, params["conv2"]["w"],
                                 params["conv2"]["b"])
    flat = a2.reshape(a2.shape[0], a2.shape[1], -1)
    logits, rfc = knl.fc_chain_fwd_k(flat, params)
    return logits, (r1, r2, flat, rfc)


def backward_k(params: dict, residuals, dlogits: torch.Tensor,
               need_dx: bool = False):
    """Hand-written backward through the kernels: dlogits (K, B, classes)
    -> per-user grads (+ the image gradient when ``need_dx``)."""
    r1, r2, flat, rfc = residuals
    gfc, dflat = knl.fc_chain_bwd_k(flat, rfc, params, dlogits)
    k, bs, h, wd, o = r2[1].shape
    da2 = dflat.reshape(k, bs, h // 2, wd // 2, o)
    dw2, db2, da1 = knl.conv_pool_bwd_k(r2, params["conv2"]["w"], da2, True)
    dw1, db1, dx = knl.conv_pool_bwd_k(r1, params["conv1"]["w"], da1,
                                       need_dx)
    grads = {"conv1": {"w": dw1, "b": db1}, "conv2": {"w": dw2, "b": db2},
             **gfc}
    return grads, dx


def make_stacked_loss_grad(policy: ForwardPolicy) -> Callable:
    """``(stacked_params, bx, by) -> (loss (K,), grads)`` over the selected
    cohort: params leaves (K, ...), bx (K, B, H, W, C), by (K, B).  The
    closed-form ``(softmax − onehot)/B`` cotangent feeds the hand-written
    backward; loss and cotangent are computed in f32."""
    policy.validate()

    def loss_grad_k(params, bx, by):
        logits, res = forward_fwd_k(params, bx)
        zm = logits - logits.amax(dim=-1, keepdim=True)
        logz = torch.log(torch.sum(torch.exp(zm), dim=-1, keepdim=True))
        logp = zm - logz
        onehot = torch.nn.functional.one_hot(
            by.long(), logits.shape[-1]).to(torch.float32)
        loss = -torch.mean(torch.sum(onehot * logp, dim=-1), dim=-1)
        dlogits = (torch.exp(logp) - onehot) / logits.shape[1]
        grads, _ = backward_k(params, res, dlogits, need_dx=False)
        return loss, grads

    return loss_grad_k


def make_stacked_epoch_fn(policy: ForwardPolicy, lr: float) -> Callable:
    """``epoch_all(stacked, xs, ys) -> stacked``: one local epoch of SGD for
    the whole cohort, xs (K, steps, B, ...), ys (K, steps, B).

    A Python loop over the steps replaces the reference's ``lax.scan``.
    The reference donates its scan carry; here the stacked params are
    updated in place (``w -= lr·g``) and the same tree is returned."""
    loss_grad_k = make_stacked_loss_grad(policy)

    @torch.no_grad()
    def epoch_all(stacked, xs, ys):
        sx = xs.transpose(0, 1).contiguous()       # (steps, K, B, ...)
        sy = ys.transpose(0, 1).contiguous()
        for s in range(sx.shape[0]):
            _, g = loss_grad_k(stacked, sx[s], sy[s])
            for w, gg in zip(tree_leaves(stacked), tree_leaves(g)):
                w.sub_(gg.mul_(lr))
        return stacked

    return epoch_all


def make_eval_forward(policy: ForwardPolicy) -> Callable:
    """``eval_fwd(params, images) -> logits`` for one (unstacked) model over
    a whole test set, through the forward kernels with K=1 and without
    writing the training residuals."""
    policy.validate()

    @torch.no_grad()
    def eval_fwd(params, images):
        p = tree_map(lambda t: t.unsqueeze(0), params)
        x = images.unsqueeze(0)
        a1, _ = knl.conv_pool_fwd_k(x, p["conv1"]["w"], p["conv1"]["b"],
                                    residuals=False)
        a2, _ = knl.conv_pool_fwd_k(a1, p["conv2"]["w"], p["conv2"]["b"],
                                    residuals=False)
        logits, _ = knl.fc_chain_fwd_k(a2.reshape(1, a2.shape[1], -1), p)
        return logits[0]

    return eval_fwd
