"""Param initialisers on a ``torch.Generator`` (``repro/models/module.py``).

Params are plain nested dicts of tensors.  Every draw is made on the
generator's own device and the result moves to ``device``: a CPU generator
gives the same weights on every device, a CUDA generator draws on the card
(fast at full size, but its numbers are not the CPU generator's).  The
numbers differ from ``jax.random``'s for the same seed: tests that compare
the packages hand the JAX init across as numpy (``repro_torch.convert``).

Stacked decoder layers (``stack_layers``) run a single-layer init once per
layer from the one generator and stack the leaves on a leading
``(num_layers, ...)`` axis, the layout ``jax.vmap`` gives the reference.

On the ``meta`` device the initialisers draw nothing: every leaf is an
empty meta tensor of its shape and dtype, and the generator is never
read (``None`` will do).  That is the port's ``jax.eval_shape(init)``
(``registry.abstract_init``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.sharding.apply import is_dtensor
from repro_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def is_meta(device) -> bool:
    """True for the ``meta`` device: shapes and dtypes only, no draws."""
    return device is not None and torch.device(device).type == "meta"


def normal(gen: torch.Generator, shape, scale: float, device=None,
           dtype=torch.float32) -> torch.Tensor:
    if is_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


def uniform(gen: torch.Generator, shape, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) draws, as ``jax.random.uniform``'s default range."""
    if is_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.rand(shape, generator=gen, device=gen.device)
    return w.to(device=device, dtype=dtype)


def linspace(start: float, end: float, n: int, device=None,
             dtype=torch.float32) -> torch.Tensor:
    return torch.linspace(start, end, n, dtype=torch.float32,
                          device=device).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device=None,
               scale: float | None = None, dtype=torch.float32
               ) -> torch.Tensor:
    """Fan-in scaled truncated-normal (LeCun) weight (in_dim, out_dim)."""
    if is_meta(device):
        return torch.empty(in_dim, out_dim, dtype=dtype, device=device)
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty(in_dim, out_dim, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, device=None,
               dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02, device, dtype)


def stack_layers(init_fn: Callable[[torch.Generator], Params],
                 gen: torch.Generator, num_layers: int) -> Params:
    """One single-layer init per layer, in order, from ``gen`` -> stacked
    leaves (L, ...)."""
    layers = [init_fn(gen) for _ in range(num_layers)]
    return tree_map(lambda *ls: torch.stack(ls), *layers)


def records_grad(*ts) -> bool:
    """True where autograd records an op on ``ts``: grad mode is on and one
    of them requires a gradient.  The full-sequence paths take the
    reference's differentiable einsum code there, and the forward-only
    kernels elsewhere."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def einsum_path(*ts) -> bool:
    """True where the full-sequence paths take the reference's einsum
    code (its ``impl="xla"`` program) rather than a forward-only kernel:
    where autograd records (``records_grad``), and where an input is a
    ``DTensor`` (a sharded or dry-run program: a kernel reads raw pointers,
    which a DTensor has only for its local shard)."""
    return records_grad(*ts) or any(is_dtensor(t) for t in ts)


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def param_bytes(params: Params) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(params))
