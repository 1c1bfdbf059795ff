"""Activation sharding constraints threaded through the model code, the
placing of whole trees on a mesh, and the rules a DTensor program needs
where GSPMD would find its own way (``repro/sharding/apply.py``).

DTensor's propagation alone replicates the batch through the attention
head reshape wherever head counts do not divide the model axis (hymba
25H, qwen2-vl 12H, granite 24H, llama4 40H, and every GQA arch's KV=8 <
16), so the model bodies call ``constrain`` at the reference's canonical
points (post-embed, post-projection, per-layer output).  ``act`` is None
outside the dry run, and ``constrain`` is then the identity; it is also
the identity on a tensor that is not a ``DTensor``, so the bodies keep
every plain-tensor output bitwise.

act = {"batch": ("data",) | ("pod", "data"), "model": "model",
       "model_size": 16, "batch_size": 16 | 32}

Where GSPMD reshards on its own and DTensor does not, the bodies go
through: ``reshape`` (gathers what a split cannot carry through a
reshape), ``split_map`` (work independent along a batch and a head dim
runs on each rank's shards), ``take_rows`` (an embedding lookup),
``on_replicas`` (work whose tokens share slots runs on gathered
replicas), ``experts_on_shards`` (the moe experts on their weights'
shards), ``settle`` (a partial sum done where GSPMD would do it), and
``grad_like`` (a param's gradient in the param's layout).
Each is ``fn`` itself, or the identity, on plain tensors.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.sharding.rules import Spec, placements
from repro_torch.utils.tree import tree_map


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Layout(torch.autograd.Function):
    """Redistribute a DTensor to ``want``; its gradient goes back to the
    input's own layout, summed where that was a ``Partial``.  DTensor's
    own ``redistribute`` hands back a lazy ``Partial`` gradient, which its
    propagation then meets by gathering whole weights: GSPMD, whose
    constraint also binds the cotangent, sums it."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return like(g, ctx.back), None


class _GradLike(torch.autograd.Function):
    """The identity; the gradient laid out as the input is."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return like(g, ctx.placements)


def like(g, placements):
    """The DTensor ``g`` laid out by ``placements`` (a param's: its
    gradient summed into the param's own shards)."""
    placements = tuple(placements)
    if tuple(g.placements) == placements:
        return g
    return g.redistribute(g.device_mesh, placements)


def grad_like(x):
    """``x``, whose gradient is laid out as ``x`` is: a DTensor param's
    gradient lands in the param's own layout, as GSPMD gives it, and not
    in whatever layout DTensor's propagation picks for the op that used
    it.  The identity on a plain tensor, or where autograd does not
    record."""
    if not (is_dtensor(x) and torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradLike.apply(x)


def constrain(x, act: Optional[dict], *entries):
    """Lay the DTensor ``x`` (and its gradient) out as ``entries`` name, on
    its own mesh; the identity where ``act`` is None or ``x`` is a plain
    tensor.

    entries use the placeholders 'B' (the batch axes), 'M' (the model
    axis) and None."""
    if act is None or not is_dtensor(x):
        return x
    spec = Spec(*(act["batch"] if e == "B" else act["model"] if e == "M"
                  else None for e in entries))
    want = placements(x.device_mesh, spec)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Layout.apply(x, want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def settle(x):
    """The DTensor ``x`` with its pending sums done (each ``Partial``
    placement made ``Replicate``: an all-reduce), its gradient laid back
    out as ``x``'s; the identity on a plain tensor or a settled one.
    GSPMD sums a contraction's partial result where the next op needs it;
    DTensor carries the ``Partial`` on, and its propagation of a product
    of a ``Partial`` and a strided shard fails."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Layout.apply(x, want)
    return x.redistribute(x.device_mesh, want)


def _groups(old, new):
    """Pair the dims of two shapes of one size into groups of equal
    product: [(old dims, new dims), ...], in order."""
    out, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        gi, gj = [], []
        po = pn = 1
        while True:
            if i < len(old) and (po < pn or not gi or
                                 (po == pn and j >= len(new))):
                po *= old[i]
                gi.append(i)
                i += 1
            elif j < len(new) and (pn < po or not gj):
                pn *= new[j]
                gj.append(j)
                j += 1
            else:
                break
            if po == pn and gi and gj:
                break
        out.append((gi, gj))
    return out


def reshape(x, *shape):
    """``x.reshape(*shape)``.  On a DTensor, a mesh axis that splits a dim
    DTensor cannot carry through the reshape is gathered first: a dim
    merged after the first of its group, or a dim split into parts whose
    leading size does not divide by its shards (Llama's 8 KV heads over a
    16-way axis).  GSPMD reshards there on its own; DTensor asks the
    program to."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate, Shard
    old = tuple(x.shape)
    new = tuple(shape[0]) if len(shape) == 1 and isinstance(
        shape[0], (tuple, list, torch.Size)) else tuple(shape)
    if -1 in new:
        known = 1
        for n in new:
            if n != -1:
                known *= n
        total = 1
        for n in old:
            total *= n
        new = tuple(total // known if n == -1 else n for n in new)
    mesh = x.device_mesh
    shards = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            shards.setdefault(p.dim, []).append(i)
    want = list(x.placements)
    for gi, gj in _groups(old, new):
        for d in gi:
            if d not in shards:
                continue
            n = 1
            for i in shards[d]:
                n *= mesh.size(i)
            if d != gi[0] or not gj or new[gj[0]] % n:
                for i in shards[d]:
                    want[i] = Replicate()
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    return x.reshape(new)


def on_replicas(fn, *trees):
    """``fn(*trees)`` where the trees hold DTensors: every DTensor leaf is
    gathered whole (``Replicate`` on every mesh axis) and ``fn`` runs on
    the plain local tensors; each tensor it returns comes back as a
    replicated DTensor.  Differentiable.  For code whose tokens compete
    for shared slots (the moe scatter's capacity), which no split of the
    batch keeps exact.  Without a DTensor among the leaves it is
    ``fn(*trees)``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_flatten, tree_map as pt_map
    mesh = next((t.device_mesh for t in tree_flatten(trees)[0]
                 if isinstance(t, DTensor)), None)
    if mesh is None:
        return fn(*trees)
    whole = (Replicate(),) * mesh.ndim

    def local(t):
        if not isinstance(t, DTensor):
            return t
        if tuple(t.placements) != whole:
            t = t.redistribute(mesh, whole)
        return t.to_local()

    out = fn(*pt_map(local, trees))
    return pt_map(lambda t: DTensor.from_local(t, mesh, whole,
                                               run_check=False)
                  if isinstance(t, torch.Tensor) else t, out)


class _SumShards(torch.autograd.Function):
    """Each rank's local ``out`` as one DTensor laid out by ``placements``
    (a ``Shard`` or a ``Partial`` on the split axes), made whole on every
    rank (an all-gather or an all-reduce).  The gradient of a rank's part
    is the whole gradient's own part: its chunk of a ``Shard`` dim, all
    of it for a ``Partial`` (DTensor's ``from_local`` would hand a
    ``Partial`` part a share of it)."""

    @staticmethod
    def forward(ctx, out, mesh, placements):
        from torch.distributed.tensor import DTensor, Replicate
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in placements)
        whole = (Replicate(),) * mesh.ndim
        return DTensor.from_local(out, mesh, placements,
                                  run_check=False).redistribute(mesh, whole)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.back).to_local(), None, None


def experts_on_shards(fn, weights, x):
    """``fn(weights, x)`` for stacked expert weights (leaves (E, ...):
    ``w_gate``, ``w_up`` (E, d, ff), ``w_down`` (E, ff, d)) and a
    replicated DTensor ``x`` (E, C, d), each rank on its own shard of the
    experts' work, laid out as the weights are over the mesh's ``model``
    axis: their E dim (expert parallel) or their hidden dim ff (each
    expert's columns in, rows out).  Every other axis of the weights
    (the FSDP split of d over data) is gathered, as GSPMD gathers it.
    With E split, a rank runs its experts on their slots and the outputs
    are gathered whole; with the hidden dim split, it runs every expert
    on its columns and the partial outputs are summed.  The result is a
    replicated DTensor (E, C, d)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    axis = names.index("model") if "model" in names else mesh.ndim - 1
    split = weights["w_gate"].placements[axis]
    ep = split == Shard(0)
    local = {}
    for name, w in weights.items():
        want = tuple(p if i == axis else Replicate()
                     for i, p in enumerate(w.placements))
        if tuple(w.placements) != want:
            w = w.redistribute(mesh, want)
        local[name] = w.to_local(grad_placements=want)
    whole = (Replicate(),) * mesh.ndim
    if tuple(x.placements) != whole:
        x = x.redistribute(mesh, whole)
    if ep:
        part = tuple(Shard(0) if i == axis else Replicate()
                     for i in range(mesh.ndim))
        xl = x.redistribute(mesh, part).to_local(grad_placements=part)
    elif isinstance(split, Shard):
        part = tuple(Partial() if i == axis else Replicate()
                     for i in range(mesh.ndim))
        xl = x.to_local(grad_placements=part)
    else:                               # weights whole on the model axis
        part = whole
        xl = x.to_local(grad_placements=part)
    return _SumShards.apply(fn(local, xl), mesh, part)


def split_map(fn, args, dims, out_dims, ref: int = 0):
    """``fn(*args)`` on each rank's own shards, for work independent along
    a batch dim and a head (or channel) dim, as attention, the WKV
    recurrence and the selective scan are.  ``dims[i]`` names arg i's
    (batch dim, head dim), None where it has none; ``out_dims`` the
    outputs', which carry every dim a mesh axis splits.  Each mesh axis
    splits the batch, the heads or nothing, as it splits ``args[ref]``;
    every other arg is laid out alike (a plain tensor as a replicated one)
    and ``fn`` runs on the plain local tensors.  An arg that a splitting
    axis does not split (``u`` beside split heads and batch) gets a partial
    gradient on each rank, summed over that axis.  This is GSPMD's
    partition of the same einsums: DTensor's own propagation cannot carry
    their flattened (batch, head) dims.  Without a DTensor at
    ``args[ref]`` it is ``fn(*args)``."""
    if not is_dtensor(args[ref]):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = args[ref]
    mesh = x.device_mesh
    rb, rh = dims[ref]
    roles = ["b" if p == Shard(rb) else "h" if rh is not None and
             p == Shard(rh) else None
             for p in x.placements] if rb is not None else [
        "h" if rh is not None and p == Shard(rh) else None
        for p in x.placements]

    def layout(bh, partial_grad=False):
        b, h = bh
        out = []
        for role in roles:
            d = b if role == "b" else h if role == "h" else None
            if d is not None:
                out.append(Shard(d))
            elif role is not None and partial_grad:
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)

    whole = (Replicate(),) * mesh.ndim
    local = []
    for a, bh in zip(args, dims):
        if not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, whole, run_check=False)
        want = layout(bh)
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        local.append(a.to_local(grad_placements=layout(bh, True)))
    out = fn(*local)
    single = isinstance(out, torch.Tensor)
    wrapped = []
    for o, bh in zip((out,) if single else out, out_dims):
        if any(role is not None and Partial() == p
               for role, p in zip(roles, layout(bh, True))):
            raise ValueError(f"split_map: an output laid out {bh} lacks a "
                             f"dim the mesh splits")
        wrapped.append(DTensor.from_local(o, mesh, layout(bh),
                                          run_check=False))
    return wrapped[0] if single else tuple(wrapped)


def take_rows(table, idx):
    """``table[idx]`` for a DTensor ``table`` (an embedding): every rank
    gathers the whole table and looks up the rows of its own shard of
    ``idx``, and the table's gradient, a partial sum along the mesh axes
    that split ``idx`` (whole along the others), is summed into the
    table's own layout.  The lookup and its backward run on local tensors:
    DTensor's own index strategies vary between torch releases (2.11's
    ``index_put`` refuses the embedding's backward)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    whole = (Replicate(),) * mesh.ndim
    where = tuple(idx.placements) if is_dtensor(idx) else whole
    if is_dtensor(idx):
        idx = idx.to_local()
    t = table if tuple(table.placements) == whole \
        else table.redistribute(mesh, whole)
    t = t.to_local(grad_placements=tuple(
        Partial() if isinstance(p, Shard) else Replicate() for p in where))
    return DTensor.from_local(t[idx.long()], mesh, where, run_check=False)


def heads_shardable(act: Optional[dict], num_heads: int) -> bool:
    return act is not None and num_heads % act.get("model_size", 16) == 0


def batch_shardable(act: Optional[dict], batch: int) -> bool:
    if act is None:
        return False
    n = act.get("batch_size", 16)
    return batch % n == 0 and batch > 1


def distribute_tree(mesh, tree: Any, specs: Any) -> Any:
    """Place every tensor leaf of ``tree`` on ``mesh`` by the matching leaf
    of the spec tree ``specs`` (a ``TrainState``, nested dicts, or one
    tensor).  Each rank keeps its own shard of the leaf it holds (no
    collective: every rank is expected to hold the same full tree, as
    ranks drawing from one seed do); None stays None."""
    from torch.distributed.tensor import distribute_tensor

    def put(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, placements(mesh, spec),
                                 src_data_rank=None)

    return tree_map(put, tree, specs)
