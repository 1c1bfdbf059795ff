"""Forward-policy layer: how the CNN hot path computes
(``repro/kernels/fused_cnn/ops.py``).

``ForwardPolicy`` keeps the reference's fields, so a JAX config carries
over, and the port accepts every policy the reference accepts:

  kernel    "xla", "pallas" — the pool-first step with the hand-written
                       backward, through the CUDA kernels of ``kernel.py``
                       (their plain twins on CPU tensors).  The reference's
                       two names are one algorithm there (pinned equal) and
                       one path here.
            "im2col" — the autodiff baseline: ``cnn.forward_im2col`` and
                       autograd, plain torch (the reference leaves it to
                       XLA: no kernel of its own).
  precision "f32"    — everything f32.
            "bf16"   — mixed precision: bf16 compute, f32 accumulation in
                       every product, f32 loss, f32 grads, f32 master
                       params (see ``make_stacked_epoch_fn``).  The im2col
                       baseline keeps its compute-dtype products (plain
                       ``@``).
  batch_users True   — the blocked kernels: one launch per layer for the
                       whole cohort (``make_stacked_loss_grad``).
            False    — the single-user kernels, launched once per user
                       slot per layer: a loop over ``make_loss_grad``
                       that stacks the results (the reference vmaps it).

``block_k`` is validated and has no effect: the CUDA kernels choose their
own tiling.  Everything between the kernels (the softmax cross-entropy
cotangent, the SGD update) is plain torch, as the reference leaves it to
XLA outside its kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels.fused_cnn import kernel as knl
from repro_torch.models import cnn as cnn_mod
from repro_torch.training.loss import cross_entropy
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

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
        return self

    @property
    def compute_dtype(self):
        """bf16 under the mixed-precision policy, else None (f32)."""
        return torch.bfloat16 if self.precision == "bf16" else None


def _cast_tree(tree: Any, dtype) -> Any:
    return tree_map(lambda t: t.to(dtype), tree)


def _cast_in(params, images, cd):
    """Params and images in the compute dtype (no-op at f32)."""
    if cd is None:
        return params, images
    return _cast_tree(params, cd), images.to(cd)


# ---------------------------------------------------------------------------
# single-user step: one user's params and batch per call
# ---------------------------------------------------------------------------

def forward_fwd(params: dict, images: torch.Tensor):
    """One user's forward + residuals through the single-user kernels:
    images (B, H, W, C)."""
    a1, r1 = knl.conv_pool_fwd(images, params["conv1"]["w"],
                               params["conv1"]["b"])
    a2, r2 = knl.conv_pool_fwd(a1, params["conv2"]["w"],
                               params["conv2"]["b"])
    flat = a2.reshape(a2.shape[0], -1)
    logits, rfc = knl.fc_chain_fwd(flat, params)
    return logits, (r1, r2, flat, rfc)


def backward(params: dict, residuals, dlogits: torch.Tensor,
             need_dx: bool = True):
    """One user's hand-written backward through the single-user kernels:
    dlogits (B, classes) -> grads (+ the image gradient when ``need_dx``;
    the training step skips it)."""
    r1, r2, flat, rfc = residuals
    gfc, dflat = knl.fc_chain_bwd(flat, rfc, params, dlogits)
    bs, h, wd, o = r2[1].shape
    da2 = dflat.reshape(bs, h // 2, wd // 2, o)
    dw2, db2, da1 = knl.conv_pool_bwd(r2, params["conv2"]["w"], da2, True)
    dw1, db1, dx = knl.conv_pool_bwd(r1, params["conv1"]["w"], da1, need_dx)
    grads = {"conv1": {"w": dw1, "b": db1}, "conv2": {"w": dw2, "b": db2},
             **gfc}
    return grads, dx


class _KernelForward(torch.autograd.Function):
    """logits = forward(params, images) through the single-user kernels;
    the backward runs the hand-written backward with the image gradient.
    Grads and the image cotangent come back f32 (the master dtype at the
    f32 policy)."""

    @staticmethod
    def forward(ctx, cd, like, images, *leaves):
        params, x = _cast_in(tree_unflatten(like, iter(leaves)), images, cd)
        logits, res = forward_fwd(params, x)
        ctx.cd, ctx.params, ctx.res = cd, params, res
        ctx.dtypes = [t.dtype for t in leaves]
        return logits.float() if cd is not None else logits

    @staticmethod
    def backward(ctx, g):
        cd = ctx.cd
        gc = (g.to(cd) if cd is not None else g).contiguous()
        grads, dx = backward(ctx.params, ctx.res, gc, need_dx=True)
        leaves = tree_leaves(grads)
        if cd is None:
            leaves = [gg.to(dt) for gg, dt in zip(leaves, ctx.dtypes)]
        return (None, None, dx.float(), *leaves)


def make_forward(policy: ForwardPolicy) -> Callable:
    """``forward(params, images) -> logits`` for one user, differentiable
    by autograd: the kernels with the hand-written backward attached, or
    for "im2col" ``cnn.forward_im2col`` under plain autograd."""
    policy.validate()
    cd = policy.compute_dtype
    if policy.kernel == "im2col":
        if cd is None:
            return cnn_mod.forward_im2col
        return partial(cnn_mod.forward_im2col, compute_dtype=cd)

    def forward(params, images):
        return _KernelForward.apply(cd, params, images,
                                    *tree_leaves(params))

    return forward


def _ce_cotangent(logits: torch.Tensor, labels: torch.Tensor):
    """f32 mean softmax cross entropy over the batch axis (-2) and its
    closed-form cotangent ``(softmax − onehot)/B``."""
    lf = logits.float()
    zm = lf - lf.amax(dim=-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(zm), dim=-1, keepdim=True))
    logp = zm - logz
    onehot = torch.nn.functional.one_hot(labels.long(),
                                         lf.shape[-1]).to(torch.float32)
    loss = -torch.mean(torch.sum(onehot * logp, dim=-1), dim=-1)
    dlogits = (torch.exp(logp) - onehot) / lf.shape[-2]
    return loss, dlogits


def make_loss_grad(policy: ForwardPolicy) -> Callable:
    """``(params, bx, by) -> (loss, grads)`` for one user: the closed-form
    CE cotangent feeds the hand-written backward through the single-user
    kernels (``need_dx=False``); loss and grads f32.  "im2col" is autograd
    around ``make_forward``."""
    policy.validate()
    if policy.kernel == "im2col":
        return _autodiff_loss_grad(make_forward(policy))
    cd = policy.compute_dtype

    def loss_grad(params, bx, by):
        p, x = _cast_in(params, bx, cd)
        logits, res = forward_fwd(p, x)
        loss, dlogits = _ce_cotangent(logits, by)
        grads, _ = backward(p, res, dlogits.to(logits.dtype),
                            need_dx=False)
        return loss, grads

    return loss_grad


def _autodiff_loss_grad(fwd: Callable) -> Callable:
    """``(params, bx, by) -> (loss, grads)`` by autograd of
    ``cross_entropy(fwd(params, bx), by)``; grads in the params' dtypes."""

    def loss_grad(params, bx, by):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss = cross_entropy(fwd(p, bx), by)
            grads = torch.autograd.grad(loss, tree_leaves(p))
        return loss.detach(), tree_unflatten(p, iter(grads))

    return loss_grad


def make_eval_forward(policy: ForwardPolicy) -> Callable:
    """``eval_fwd(params, images) -> logits`` (f32) for one (unstacked)
    model over a whole test set: the forward kernels at K=1 without writing
    the training residuals, in the policy's compute dtype; for "im2col"
    ``make_forward``."""
    policy.validate()
    cd = policy.compute_dtype
    if policy.kernel == "im2col":
        return torch.no_grad()(make_forward(policy))

    @torch.no_grad()
    def eval_fwd(params, images):
        p, x = _cast_in(tree_map(lambda t: t.unsqueeze(0), params),
                        images.unsqueeze(0), cd)
        a1, _ = knl.conv_pool_fwd_k(x, p["conv1"]["w"], p["conv1"]["b"],
                                    residuals=False)
        a2, _ = knl.conv_pool_fwd_k(a1, p["conv2"]["w"], p["conv2"]["b"],
                                    residuals=False)
        logits, _ = knl.fc_chain_fwd_k(a2.reshape(1, a2.shape[1], -1), p)
        return logits[0].float()

    return eval_fwd


def make_stacked_eval_forward(policy: ForwardPolicy) -> Callable:
    """``eval_fwd_k(params, images) -> logits`` (G, B, classes) f32 for G
    models (params leaves (G, ...)) on their own test sets, images
    (G, B, H, W, C): the blocked forward kernels at K = G without the
    training residuals, one launch per layer, in the policy's compute
    dtype.  "im2col" and ``batch_users=False`` evaluate the G models one
    by one through ``make_eval_forward``."""
    policy.validate()
    if policy.kernel == "im2col" or not policy.batch_users:
        one = make_eval_forward(policy)

        def eval_each(params, images):
            return torch.stack([one(tree_map(lambda t: t[g], params),
                                    images[g])
                                for g in range(images.shape[0])])

        return eval_each
    cd = policy.compute_dtype

    @torch.no_grad()
    def eval_fwd_k(params, images):
        p, x = _cast_in(params, images, cd)
        a1, _ = knl.conv_pool_fwd_k(x, p["conv1"]["w"], p["conv1"]["b"],
                                    residuals=False)
        a2, _ = knl.conv_pool_fwd_k(a1, p["conv2"]["w"], p["conv2"]["b"],
                                    residuals=False)
        logits, _ = knl.fc_chain_fwd_k(
            a2.reshape(a2.shape[0], a2.shape[1], -1), p)
        return logits.float()

    return eval_fwd_k


# ---------------------------------------------------------------------------
# stacked-cohort step: the K-user axis handled by the kernels
# ---------------------------------------------------------------------------

def forward_fwd_k(params: dict, images: torch.Tensor):
    """Stacked-cohort forward + residuals through the blocked kernels:
    params leaves (K, ...), images (K, B, H, W, C)."""
    a1, r1 = knl.conv_pool_fwd_k(images, params["conv1"]["w"],
                                 params["conv1"]["b"])
    a2, r2 = knl.conv_pool_fwd_k(a1, params["conv2"]["w"],
                                 params["conv2"]["b"])
    flat = a2.reshape(a2.shape[0], a2.shape[1], -1)
    logits, rfc = knl.fc_chain_fwd_k(flat, params)
    return logits, (r1, r2, flat, rfc)


def backward_k(params: dict, residuals, dlogits: torch.Tensor,
               need_dx: bool = False):
    """Hand-written backward through the blocked kernels: dlogits
    (K, B, classes) -> per-user grads (+ the image gradient when
    ``need_dx``)."""
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


def _per_user(fn: Callable) -> Callable:
    """``fn(params, bx, by) -> (out, tree)`` for one user, run for each
    user of a stacked cohort and stacked: the port's ``vmap``."""

    def stacked_fn(params, bx, by):
        outs = [fn(tree_map(lambda t: t[k], params), bx[k], by[k])
                for k in range(by.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                tree_map(lambda *ls: torch.stack(ls), *[o[1] for o in outs]))

    return stacked_fn


def make_stacked_loss_grad(policy: ForwardPolicy) -> Callable:
    """``(stacked_params, bx, by) -> (loss (K,), grads)`` over the selected
    cohort: params leaves (K, ...), bx (K, B, H, W, C), by (K, B).  The
    blocked kernels take the whole cohort per launch; "im2col" and
    ``batch_users=False`` loop over the users through ``make_loss_grad``
    (the reference's ``vmap``).  Loss and cotangent are f32; the
    cotangent is cast to the compute dtype before the backward."""
    policy.validate()
    if policy.kernel == "im2col" or not policy.batch_users:
        return _per_user(make_loss_grad(policy))
    cd = policy.compute_dtype

    def loss_grad_k(params, bx, by):
        p, x = _cast_in(params, bx, cd)
        logits, res = forward_fwd_k(p, x)
        loss, dlogits = _ce_cotangent(logits, by)
        grads, _ = backward_k(p, res, dlogits.to(logits.dtype),
                              need_dx=False)
        return loss, grads

    return loss_grad_k


def make_stacked_epoch_fn(policy: ForwardPolicy, lr: float) -> Callable:
    """``epoch_all(stacked, xs, ys) -> stacked``: one local epoch of SGD for
    the whole cohort, xs (K, steps, B, ...), ys (K, steps, B).

    A Python loop over the steps replaces the reference's ``lax.scan``.
    The reference donates its scan carry; here the stacked f32 master
    params are updated in place and the same tree is returned.

    bf16 policy (xla/pallas): the master round trip sits at the epoch
    boundary, as in the reference.  Images and params are cast to bf16
    once per epoch; the steps carry the bf16 trajectory,
    p = bf16(p − bf16(bf16(lr)·bf16(g))) (XLA's rounding of the
    reference's ``w - lr * g.astype(bf16)``), and an f32 gradient
    accumulator; the master is updated once, ``master − lr·Σg`` in f32.
    "im2col" keeps the per-step f32 master update (its grads come back
    f32)."""
    loss_grad_k = make_stacked_loss_grad(policy)
    bf16_fast = policy.precision == "bf16" and policy.kernel != "im2col"
    # bf16(lr), as XLA converts the weakly typed Python scalar
    lr_bf16 = float(torch.tensor(lr, dtype=torch.bfloat16))

    @torch.no_grad()
    def epoch_all(stacked, xs, ys):
        sx = xs.transpose(0, 1).contiguous()       # (steps, K, B, ...)
        sy = ys.transpose(0, 1).contiguous()
        if not bf16_fast:
            for s in range(sx.shape[0]):
                _, g = loss_grad_k(stacked, sx[s], sy[s])
                for w, gg in zip(tree_leaves(stacked), tree_leaves(g)):
                    w.sub_(gg.mul_(lr))
            return stacked
        sx = sx.to(torch.bfloat16)                 # cast once per epoch
        p = _cast_tree(stacked, torch.bfloat16)
        acc = tree_map(torch.zeros_like, stacked)  # f32 accumulator
        for s in range(sx.shape[0]):
            _, g = loss_grad_k(p, sx[s], sy[s])
            for w, a, gg in zip(tree_leaves(p), tree_leaves(acc),
                                tree_leaves(g)):
                a.add_(gg)
                w.sub_(gg.to(torch.bfloat16).mul_(lr_bf16))
        for w, a in zip(tree_leaves(stacked), tree_leaves(acc)):
            w.sub_(a.mul_(lr))
        return stacked

    return epoch_all


def resolve_train_step(forward: Any) -> Tuple[Callable, Callable]:
    """``forward=`` of ``build_fused_round`` as ``(loss_grad, eval_fwd)``:
    the one-user training step and the eval forward.

    - ``None``: the default ``ForwardPolicy()``;
    - a ``ForwardPolicy``: its compute path;
    - any other callable ``forward(params, x) -> logits``: autograd around
      it, and used as it is for eval (the hook that pushes non-CNN models
      through the round).
    """
    if forward is None:
        forward = ForwardPolicy()
    if isinstance(forward, ForwardPolicy):
        return make_loss_grad(forward), make_eval_forward(forward)
    return _autodiff_loss_grad(forward), forward
