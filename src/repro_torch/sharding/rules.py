"""Partition specs for every family, and their DTensor placements
(``repro/sharding/rules.py``).

Scheme: 2D param sharding, FSDP along ``data`` on the input/feature dim
and tensor parallel along ``model`` on the flattened heads·head_dim / ffn
dim (head counts are never sharded directly: hymba's 25, qwen2-vl's 12
and granite's 24 heads do not divide the 16-way model axis, their
flattened feature dims do).  Params are replicated over ``pod``;
cross-pod traffic belongs to OpportunisticSync.

MoE placement: llama4's 128 experts are expert-parallel on ``model``
(8 a shard); granite's 40 do not divide 16, so its experts are
replicated and sharded inside each expert (moe_d_ff 512/16 = 32).

Decode caches shard the cache-position axis over ``model`` (batch over
data): KV head counts (8, 5, 2) do not divide 16, cache positions do.

A spec is a ``Spec``: a tuple with one entry per leading tensor dim, each
an axis name, a tuple of axis names (the dim split over several mesh
axes, major first) or ``None`` (not split); dims past its end are not
split.  ``placements`` turns one into the DTensor placements of a
``DeviceMesh``.

The sweep splits its stacked-simulation axis over ranks by blocks of rows
(``sweep_rows``), the counterpart of ``shard_sweep_tree``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import InputShape, ModelConfig

DATA, MODEL, POD = "data", "model", "pod"
SWEEP = "sweep"


class Spec(tuple):
    """A partition spec: one entry per leading tensor dim (an axis name, a
    tuple of axis names, or None).  A leaf of a spec tree.  A tuple of one
    name is that name, as ``PartitionSpec`` has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return (POD, DATA) if multi_pod else (DATA,)


def _divisible(dim: int, mesh_axis_size: int) -> bool:
    return dim % mesh_axis_size == 0


def _param_rule(cfg: ModelConfig, path: str, ndim: int) -> Spec:
    """Rule for one parameter leaf.  Stacked layer leaves carry a leading L
    dim (never sharded); the rule matches on the trailing dims."""
    stacked = path.startswith("layers/")
    lead = (None,) if stacked else ()
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    def spec(*trail):
        full = lead + trail
        if len(full) != ndim:
            raise ValueError(f"{path}: a rank-{ndim} leaf, spec {full}")
        return Spec(*full)

    # embeddings / head
    if path == "embed/table":
        return Spec(MODEL, DATA)             # vocab x d
    if path == "head/w":
        return Spec(DATA, MODEL)             # d x vocab
    # norms / small vectors
    if name in ("scale", "mu", "decay_w0", "bonus_u", "ln_scale", "D", "b"):
        return Spec(*([None] * ndim))
    # MoE
    if parent == "experts" or "experts" in path:
        expert_parallel = _divisible(cfg.num_experts, 16)
        if name in ("w_gate", "w_up"):       # (L, E, d, ff)
            return spec(MODEL, DATA, None) if expert_parallel \
                else spec(None, DATA, MODEL)
        if name == "w_down":                 # (L, E, ff, d)
            return spec(MODEL, None, DATA) if expert_parallel \
                else spec(None, MODEL, DATA)
    if name == "router":                     # (L, d, E)
        return spec(DATA, None)
    # attention / generic matmuls
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_k", "w_r",
                "w_v_up"):
        return spec(DATA, MODEL)             # (L, d, out)
    if name in ("wo", "w_down", "w_out"):
        return spec(MODEL, DATA)             # (L, out, d)
    if name in ("bq", "bk", "bv"):
        return spec(MODEL)
    # rwkv6
    if name == "w_v" and parent == "time":   # d x d value proj
        return spec(DATA, MODEL)
    if name == "w_g":
        return spec(DATA, MODEL)
    if name == "w_o":
        return spec(MODEL, DATA)
    if name == "decay_a":                    # (L, d, rank): rank tiny
        return spec(DATA, None)
    if name == "decay_b":                    # (L, rank, d)
        return spec(None, MODEL)
    # mamba
    if name == "conv_w":                     # (L, K, di)
        return spec(None, MODEL)
    if name == "w_xproj":                    # (L, di, R+2N)
        return spec(MODEL, None)
    if name == "w_dt":                       # (L, R, di)
        return spec(None, MODEL)
    if name == "log_A":                      # (L, di, N)
        return spec(MODEL, None)
    # cnn / fallback
    return Spec(*([None] * ndim))


def map_with_path(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict, the path its keys joined by
    ``/`` (``jax.tree_util``'s key path, as the reference spells it)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{path}/{k}" if path else k)
                for k in sorted(tree)}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params: Any) -> Any:
    """Spec tree matching a params tree (of tensors, meta tensors, or
    anything with a ``shape``)."""
    return map_with_path(
        lambda path, leaf: _param_rule(cfg, path, len(leaf.shape)), params)


def opt_state_specs(cfg: ModelConfig, params: Any) -> Dict[str, Any]:
    """AdamW moments mirror the param sharding; step is replicated."""
    ps = param_specs(cfg, params)
    return {"step": Spec(), "m": ps, "v": ps}


def train_state_specs(cfg: ModelConfig, params: Any):
    from repro_torch.training.train_state import TrainState
    return TrainState(params=param_specs(cfg, params),
                      opt_state=opt_state_specs(cfg, params),
                      step=Spec())


# ---------------------------------------------------------------------------
# activations / inputs / decode state
# ---------------------------------------------------------------------------

def input_sharding_specs(cfg: ModelConfig, shape: InputShape,
                         multi_pod: bool) -> Dict[str, Spec]:
    """Spec tree matching ``models.inputs.input_specs``."""
    b_ax = batch_axes(multi_pod)
    n = (2 if multi_pod else 1) * 16
    b = b_ax if (shape.global_batch > 1 and shape.global_batch % n == 0) \
        else None

    specs: Dict[str, Spec] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            specs["embeds"] = Spec(b, None, None)
            if shape.kind == "train":
                specs["labels"] = Spec(b, None)
                specs["mask"] = Spec(b, None)
        else:
            specs["tokens"] = Spec(b, None)
            if shape.kind == "train":
                specs["labels"] = Spec(b, None)
            if cfg.family == "vlm":
                specs["patch_embeds"] = Spec(b, None, None)
                specs["positions"] = Spec(b, None, None)
        return specs
    specs["token"] = Spec(b, None)
    specs["position"] = Spec(b)
    return specs


def decode_state_specs(cfg: ModelConfig, batch: int,
                       multi_pod: bool) -> Dict[str, Any]:
    """Spec tree matching ``transformer.init_decode_state``."""
    b_ax = batch_axes(multi_pod)
    n_batch_shards = (2 if multi_pod else 1) * 16
    # the batch dim is ONE spec entry (possibly a tuple of axes)
    bspec = (b_ax,) if batch % n_batch_shards == 0 and batch > 1 else (None,)
    # when the batch is not split (long_500k), the cache spreads over
    # data and model
    cache_ax = MODEL if batch > 1 else (DATA, MODEL)
    if cfg.family == "ssm":
        return {"rwkv": {
            "shift_t": Spec(None, *bspec, MODEL),
            "shift_c": Spec(None, *bspec, MODEL),
            "wkv": Spec(None, *bspec, None, None, None) if batch > 1
            else Spec(None, None, MODEL, None, None),
        }}
    st: Dict[str, Any] = {"kv": {
        "k": Spec(None, *bspec, cache_ax, None, None),
        "v": Spec(None, *bspec, cache_ax, None, None),
    }}
    if cfg.family == "hybrid":
        st["mamba"] = {
            "conv": Spec(None, *bspec, None, MODEL),
            "ssm": Spec(None, *bspec, MODEL, None),
        }
    return st


def logits_spec(multi_pod: bool, batch: int) -> Spec:
    b_ax = batch_axes(multi_pod)
    n = (2 if multi_pod else 1) * 16
    if batch % n == 0 and batch > 1:
        return Spec(b_ax, None, MODEL)
    return Spec(None, None, MODEL)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec) -> tuple:
    """The DTensor placements on ``mesh`` of a tensor laid out by ``spec``:
    one per mesh dim, ``Shard(d)`` on each mesh axis that tensor dim d
    names (a tuple of names: a ``Shard(d)`` on each, major first, which
    must follow the mesh's own order of those axes), ``Replicate()`` on
    every mesh axis the spec does not name."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for ax in axes:
            if ax not in names:
                raise KeyError(f"spec {spec} names axis {ax!r}, not an axis "
                               f"of the mesh {names}")
            if ax in used:
                raise ValueError(f"spec {spec} names axis {ax!r} twice")
            used.add(ax)
            idx.append(names.index(ax))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, "
                             f"against the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# sweep engine (core/sweep.py): the stacked-simulation axis over ranks
# ---------------------------------------------------------------------------

def sweep_leading_spec(ndim: int) -> Spec:
    """Split the leading (simulation) axis over ``sweep``; the rest
    whole."""
    return Spec(SWEEP, *([None] * (ndim - 1)))


def sweep_rows(n_sims: int, world: int, rank: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` block of a group's ``n_sims`` simulation rows that
    ``rank`` of ``world`` runs: contiguous blocks of ``n_sims / world``
    when ``world`` divides ``n_sims``, else every row on every rank (the
    reference replicates)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if n_sims % world:
        return 0, n_sims
    per = n_sims // world
    return rank * per, (rank + 1) * per
