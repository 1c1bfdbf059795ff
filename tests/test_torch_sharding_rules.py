"""The port's partition specs (``repro_torch.sharding.rules``) and its
abstract init (``models.registry.abstract_init``) against the JAX
package's, on the CPU.

The oracle is the reference's spec functions (``repro.sharding.rules``,
which ``tests/test_sharding_rules.py`` exercises) over
``jax.eval_shape(model.init)``; every comparison is exact: the same paths,
shapes, dtypes and spec entries.  ``placements`` is checked on hand-made
cases over a fake 8-rank world's ``make_debug_mesh``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.sharding import rules as jr  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.registry import abstract_init  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

AXIS_SIZE = {"data": 16, "model": 16, "pod": 2}


def _jax_path(path) -> str:
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)


def _jax_specs(tree):
    return [(_jax_path(p), tuple(s)) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))]


def _port_flat(tree, path=""):
    """[(path, leaf)] over dicts (sorted keys) and NamedTuples (fields in
    order, None holding nothing), stopping at specs and tensors."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_flat(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, t in zip(tree._fields, tree) if t is not None
                for x in _port_flat(t, join(f))]
    return [(path, tree)]


def _port_specs(tree):
    return [(p, tuple(s)) for p, s in _port_flat(tree)]


_J_SHAPES = {}


def _jax_shapes(arch):
    if arch not in _J_SHAPES:
        model = j_build_model(j_get_config(arch))
        _J_SHAPES[arch] = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return _J_SHAPES[arch]


def test_arch_ids_and_shapes_match_the_reference():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)
    assert list(INPUT_SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_init_matches_eval_shape(arch):
    """Paths, shapes and dtypes of every leaf, with nothing drawn."""
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""),
            t.device.type) for p, t in _port_flat(abstract_init(
                get_config(arch)))]
    want = [(_jax_path(p), tuple(s.shape), str(s.dtype), "meta") for p, s in
            jax.tree_util.tree_leaves_with_path(_jax_shapes(arch))]
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    got = rules.param_specs(get_config(arch), abstract_init(get_config(arch)))
    want = jr.param_specs(j_get_config(arch), _jax_shapes(arch))
    assert _port_specs(got) == _jax_specs(want)
    assert all(isinstance(s, rules.Spec) for _, s in _port_flat(got))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divide_the_production_meshes(arch):
    """Every split dim divides the product of its axes' sizes (16 x 16 and
    2 x 16 x 16; params never use ``pod``)."""
    cfg = get_config(arch)
    params = abstract_init(cfg)
    specs = dict(_port_flat(rules.param_specs(cfg, params)))
    for path, t in _port_flat(params):
        spec = specs[path]
        assert len(spec) <= t.dim()
        for dim, ax in zip(t.shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([AXIS_SIZE[a] for a in axes]))
            assert dim % total == 0, (arch, path, tuple(t.shape), spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    params, jparams = abstract_init(cfg), _jax_shapes(arch)
    assert _port_specs(rules.opt_state_specs(cfg, params)) == \
        _jax_specs(jr.opt_state_specs(jcfg, jparams))
    assert _port_specs(rules.train_state_specs(cfg, params)) == \
        _jax_specs(jr.train_state_specs(jcfg, jparams))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_specs_match_the_reference(arch, shape, multi_pod):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shp, jshp = INPUT_SHAPES[shape], J_SHAPES[shape]
    assert _port_specs(rules.input_sharding_specs(cfg, shp, multi_pod)) == \
        _jax_specs(jr.input_sharding_specs(jcfg, jshp, multi_pod))
    assert tuple(rules.logits_spec(multi_pod, shp.global_batch)) == \
        tuple(jr.logits_spec(multi_pod, jshp.global_batch))
    if shp.kind == "decode":
        assert _port_specs(rules.decode_state_specs(
            cfg, shp.global_batch, multi_pod)) == _jax_specs(
            jr.decode_state_specs(jcfg, jshp.global_batch, multi_pod))


@pytest.mark.parametrize("arch", ["llama3-405b", "rwkv6-7b", "hymba-1.5b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_decode_state_specs_divide(arch, multi_pod):
    """The port's twin of the reference's divisibility check of the decode
    caches, on the port's own ``init_decode_state`` (meta tensors)."""
    cfg = get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shp = INPUT_SHAPES[shape_name]
        ccfg = cfg if cfg.is_subquadratic or shape_name != "long_500k" \
            else cfg.with_sliding_window()
        state = tf.init_decode_state(ccfg, shp.global_batch, shp.seq_len,
                                     torch.bfloat16, "meta")
        specs = dict(_port_flat(rules.decode_state_specs(
            ccfg, shp.global_batch, multi_pod)))
        for path, t in _port_flat(state):
            for dim, ax in zip(t.shape, specs[path]):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                total = int(np.prod([AXIS_SIZE[a] for a in axes]))
                assert dim % total == 0, (arch, shape_name, path, t.shape)


@pytest.fixture
def debug_mesh():
    with tmesh.fake_world(8):
        yield tmesh.make_debug_mesh(device="cpu")


@pytest.mark.parametrize("spec, want", [
    (rules.Spec(), (Replicate(), Replicate(), Replicate())),
    (rules.Spec(None, "model"), (Replicate(), Replicate(), Shard(1))),
    (rules.Spec("model", "data"), (Replicate(), Shard(1), Shard(0))),
    (rules.Spec(("pod", "data"), None), (Shard(0), Shard(0), Replicate())),
    (rules.Spec(("pod", "data"), None, "model"),
     (Shard(0), Shard(0), Shard(2))),
    (rules.Spec(None, ("data", "model")), (Replicate(), Shard(1), Shard(1))),
    (rules.Spec(None, None, ("data",)), (Replicate(), Shard(2), Replicate())),
])
def test_placements(debug_mesh, spec, want):
    assert rules.placements(debug_mesh, spec) == want


@pytest.mark.parametrize("spec, err", [
    (rules.Spec(("data", "pod")), ValueError),     # against the mesh order
    (rules.Spec("data", "data"), ValueError),      # an axis twice
    (rules.Spec("sweep"), KeyError),               # not an axis of the mesh
])
def test_placements_refuse(debug_mesh, spec, err):
    with pytest.raises(err):
        rules.placements(debug_mesh, spec)


def test_production_mesh_needs_its_world():
    with tmesh.fake_world(8):
        with pytest.raises(ValueError, match="256"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="512"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with tmesh.fake_world(512):
        mesh = tmesh.make_production_mesh(multi_pod=True, device="cpu")
        assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)


def test_fake_world_opens_once_and_closes():
    import torch.distributed as dist
    with tmesh.fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already"):
            with tmesh.fake_world(4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="boom"):
        with tmesh.fake_world(2):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


# -- sharding/apply.py on a fake world's CPU DTensors -------------------------
# A fake world's collectives do nothing, so these check layouts and rank
# 0's own shards; values across ranks are test_torch_dryrun.py's eight
# gloo ranks'.

@pytest.fixture
def mesh22():
    with tmesh.fake_world(4):
        yield tmesh.make_mesh((2, 2), ("data", "model"), "cpu")


def _dt(mesh, x, *placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


@pytest.mark.parametrize("new, keeps", [
    ((4, 6, 2, 2), True),        # 2 heads over the 2-way model axis
    ((4, 6, 1, 4), False),       # 1 head: the model axis is gathered
    ((24, 4), False),            # merged into the batch: gathered
])
def test_reshape_gathers_only_what_a_split_cannot_carry(mesh22, new, keeps):
    from repro_torch.sharding.apply import reshape
    x = torch.arange(96, dtype=torch.float32).reshape(4, 6, 4)
    y = reshape(_dt(mesh22, x, Shard(0), Shard(2)), *new)
    assert tuple(y.shape) == new
    assert (y.placements[1] == Shard(2)) == keeps
    assert y.placements[0] == Shard(0)      # the batch is first of its group
    assert torch.equal(reshape(x, *new), x.reshape(new))


def test_constrain_lays_out_a_dtensor_and_its_gradient(mesh22):
    from repro_torch.sharding.apply import constrain, grad_like
    act = {"batch": ("data",), "model": "model"}
    x = torch.randn(4, 6, 8)
    assert constrain(x, act, "B", None, None) is x         # plain: identity
    d = _dt(mesh22, x, Replicate(), Shard(2)).requires_grad_()
    y = constrain(d, act, "B", None, None)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert constrain(d, None, "B", None, None) is d        # act None
    (g,) = torch.autograd.grad((grad_like(y) * 2.0).sum(), d)
    assert tuple(g.placements) == (Replicate(), Shard(2))  # the input's
    assert tuple(g.to_local().shape) == (4, 6, 4)


def test_distribute_tree_places_a_state_by_its_specs(mesh22):
    from repro_torch.sharding.apply import distribute_tree
    from repro_torch.training.train_state import TrainState
    p = {"a": torch.randn(4, 8), "b": torch.randn(3)}
    st = TrainState(params=p, opt_state={"step": torch.zeros(())},
                    step=torch.zeros((), dtype=torch.int32))
    specs = TrainState(params={"a": rules.Spec("data", "model"),
                               "b": rules.Spec()},
                       opt_state={"step": rules.Spec()}, step=rules.Spec())
    out = distribute_tree(mesh22, st, specs)
    assert tuple(out.params["a"].placements) == (Shard(0), Shard(1))
    assert out.params["a"].to_local().shape == (2, 4)
    assert tuple(out.params["b"].placements) == (Replicate(), Replicate())
    assert out.snapshot is None
    assert torch.equal(out.params["a"].to_local(), p["a"][:2, :4])


def test_kernel_wrappers_refuse_dtensors(mesh22):
    """A kernel reads and writes through raw pointers, which a DTensor has
    only for its shard: the wrappers refuse one, and attention on DTensors
    takes the einsum path (``impl="flash"`` raises)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import attention as attn
    q = _dt(mesh22, torch.randn(2, 8, 4, 32), Shard(0), Replicate())
    with pytest.raises(TypeError, match="plain tensors"):
        flash_attention(q, q, q)
    cfg = get_config("llama3.2-1b").reduced()
    params = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
    x = torch.randn(2, 8, cfg.d_model)
    pos = torch.arange(8)[None].expand(2, 8)
    want = attn.attend_full(params, cfg, x, pos)       # the kernel's twin
    from torch.distributed.tensor.experimental import implicit_replication
    dparams = {k: _dt(mesh22, v, Replicate(), Replicate())
               for k, v in params.items()}
    with implicit_replication():
        got = attn.attend_full(dparams, cfg, _dt(mesh22, x, Shard(0),
                                                 Replicate()), pos)
        with pytest.raises(NotImplementedError, match="DTensor"):
            attn.attend_full(dparams, cfg, _dt(mesh22, x, Shard(0),
                                               Replicate()), pos,
                             impl="flash")
    # replicated weights, the batch split over data: rank 0 computes its
    # own row with no collective
    assert tuple(got.placements) == (Shard(0), Replicate())
    assert float((got.to_local() - want[:1]).abs().max()) <= 1e-5
