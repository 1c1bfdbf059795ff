"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

The reference's own dry-run test (``tests/test_dryrun_ci.py``) fails in
tier-1, so it is no oracle.  The oracles here are:

- the reference's pure functions ``adapt_config``, ``make_opts`` and
  ``roofline_terms``, run in a subprocess (importing
  ``repro.launch.dryrun`` sets the 512 forced host devices of its world);
  equal field by field, the roofline's model FLOPs and useful ratio
  exactly, its three terms to the closed form at the H100 constants;
- the port's own unsharded train step and forward, already held to JAX
  (``test_torch_training.py``, ``test_torch_zoo_families.py``): eight gloo
  ranks on ``make_debug_mesh()`` (2 x 2 x 2) run the dry run's program on
  real tensors; loss within 1e-5 relative, params and logits within 1e-4
  of the largest magnitude (summation order only);
- the real ranks' own counts: the fake (2, 2, 2) dry run of the same step
  counts exactly rank 0's FLOPs and collectives (kind, count, bytes);
- arithmetic by hand: the argument bytes are the local shard bytes of the
  specs, and on a reduced config the calibration pair's extrapolation
  equals the full program's counts exactly.

Each fake world is opened and closed inside one test (``fake_world``).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models.registry import abstract_init  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro.configs import ARCH_IDS, INPUT_SHAPES
    from repro.launch import dryrun as RD
    out = {"cfg": {}, "opts": {}, "roof": {}}
    for a in ARCH_IDS:
        for s in INPUT_SHAPES:
            cfg = RD.adapt_config(a, s)
            key = a + "/" + s
            out["cfg"][key] = None if cfg is None else dataclasses.asdict(cfg)
            if cfg is not None:
                out["roof"][key] = RD.roofline_terms(
                    cfg, INPUT_SHAPES[s], 3.0e18, 7.0e16, 5.0e14, 256)
    for kind in ("train", "prefill", "decode"):
        for mp in (False, True):
            for disp in ("scatter", "dense"):
                for remat in ("none", "full", "dots"):
                    out["opts"][f"{kind}/{mp}/{disp}/{remat}"] = \\
                        RD.make_opts(kind, mp, disp, remat)
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _tuples_to_lists(x):
    return json.loads(json.dumps(x))


PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


@pytest.mark.parametrize("arch, shape", PAIRS)
def test_adapt_config_matches_reference(ref, arch, shape):
    import dataclasses
    cfg = D.adapt_config(arch, shape)
    want = ref["cfg"][f"{arch}/{shape}"]
    got = None if cfg is None else _tuples_to_lists(dataclasses.asdict(cfg))
    assert got == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_opts_matches_reference(ref, kind, multi_pod):
    for disp in ("scatter", "dense"):
        for remat in ("none", "full", "dots"):
            got = _tuples_to_lists(D.make_opts(kind, multi_pod, disp, remat))
            assert got == ref["opts"][f"{kind}/{multi_pod}/{disp}/{remat}"]


@pytest.mark.parametrize("arch, shape", [
    (a, s) for a, s in PAIRS if D.adapt_config(a, s) is not None])
def test_roofline_terms(ref, arch, shape):
    cfg = D.adapt_config(arch, shape)
    flops, hbm, coll, n = 3.0e18, 7.0e16, 5.0e14, 256
    got = D.roofline_terms(cfg, INPUT_SHAPES[shape], flops, hbm, coll, n)
    want = ref["roof"][f"{arch}/{shape}"]
    assert got["model_flops"] == want["model_flops"]
    assert got["useful_ratio"] == want["useful_ratio"]
    assert got["compute_s"] == flops / (n * 989.4e12)
    assert got["memory_s"] == hbm / (n * 3.35e12)
    assert got["collective_s"] == coll / (n * 50e9)
    terms = {k: got[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert got["dominant"] == max(terms, key=terms.get)


def test_run_one_lays_out_decode_on_both_meshes():
    """The port's twin of ``test_dryrun_ci.py``."""
    rec = D.run_one("llama3.2-1b", "decode_32k", multi_pod=False,
                    calibrate=False, verbose=False, device="cpu")
    assert rec["status"] == "ok", rec
    assert rec["n_chips"] == 256
    assert rec["memory"]["argument_size_in_bytes"] > 0
    rec_mp = D.run_one("llama3.2-1b", "decode_32k", multi_pod=True,
                       calibrate=False, verbose=False, device="cpu")
    assert rec_mp["status"] == "ok", rec_mp
    assert rec_mp["n_chips"] == 512
    skip = D.run_one("hubert-xlarge", "long_500k", multi_pod=False,
                     verbose=False, device="cpu")
    assert skip["status"] == "skip_documented"
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_run_one_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        D.run_one("llama3.2-1b", "decode_32k", False, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k"])


def test_main_exits_zero_on_both_meshes(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    rc = D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--both-meshes", "--no-calibrate", "--device", "cpu",
                 "--out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert [r["n_chips"] for r in recs] == [256, 512]
    assert "done: 2 programs, 0 failures" in capsys.readouterr().out


def test_a_failure_is_a_record_and_a_nonzero_exit(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("layout refused")
    monkeypatch.setattr(D, "measure", boom)
    rec = D.run_one("llama3.2-1b", "decode_32k", False, verbose=False,
                    device="cpu")
    assert rec["status"] == "fail"
    assert "layout refused" in rec["error"] and "Traceback" in \
        rec["traceback"]
    assert D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                   "--device", "cpu"]) == 1


# a reduced llama3.2-1b whose every split dim divides the 16 x 16 mesh
SMALL = dict(d_model=256, num_heads=16, num_kv_heads=8, head_dim=16,
             d_ff=512, vocab_size=4096, num_layers=4)


def _local_bytes(t, spec, sizes) -> int:
    n = t.numel() * t.element_size()
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n //= sizes[a]
    return n


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_calibration_and_argument_bytes_are_exact(shape):
    rec = D.run_one("llama3.2-1b", shape, False, cfg_overrides=SMALL,
                    verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    for key, full in rec["full_depth"].items():
        got = {"flops": "hlo_flops_per_device",
               "bytes": "hlo_bytes_per_device",
               "coll_bytes": "coll_bytes_per_device"}[key]
        assert rec[got] == full, key
    assert rec["hlo_flops_per_device"] > 0
    assert rec["per_layer"]["flops"] > 0
    # the arguments' local shards, from the specs by hand
    cfg = D.adapt_config("llama3.2-1b", shape, SMALL)
    shp = INPUT_SHAPES[shape]
    sizes = {"data": 16, "model": 16}
    args = D.abstract_args(cfg, shp, {}, "meta")
    specs = D.arg_specs(cfg, shp, False, abstract_init(cfg))
    from repro_torch.utils.tree import tree_leaves, tree_map
    per = []
    for a, s in zip(args, specs):
        tree_map(lambda t, sp: per.append(_local_bytes(t, sp, sizes)), a, s)
    assert rec["memory"]["argument_size_in_bytes"] == sum(per)
    assert len(per) == len(tree_leaves(args))


# -- sharded numerics over real ranks ----------------------------------------

# B = 32 splits the batch over pod x data by the reference's input rule
# (a multiple of 2 x 16), so the tokens arrive split as in production
B, S_TRAIN, S_MOE = 32, 1280, 64
LOSS_RTOL, PARAM_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-4


def _llama():
    return get_config("llama3.2-1b").reduced().replace(num_kv_heads=2)


def _granite():
    return get_config("granite-moe-3b-a800m").reduced().replace(
        num_kv_heads=2)


def _sharded_rank(rank, world, device):
    """One rank of eight on the (2, 2, 2) debug mesh: the dry run's train
    program (AdamW, remat full, clip 1.0) and the granite forward on real
    tensors, gathered whole; rank 0 holds them against the unsharded step
    and forward from the same state and returns its counts."""
    from repro_torch.models import build_model, inputs as zin
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.training.step import make_prefill_step
    from repro_torch.utils.op_stats import ProgramStats
    from repro_torch.utils.tree import tree_leaves
    torch.manual_seed(0)
    mesh = M.make_debug_mesh(device="cpu")
    out = {}

    cfg = _llama()
    model = build_model(cfg, "cpu")
    opts = D.make_opts("train", True)
    opt = D.optimizer(opts)
    state = create_train_state(model.init(torch.Generator().manual_seed(0)),
                               opt)
    batch = zin.materialize(zin.train_specs(cfg, B, S_TRAIN), cfg, seed=1,
                            device="cpu")
    fn, args = D.build_program(cfg, InputShape("debug", S_TRAIN, B, "train"),
                               mesh, True, opts, "cpu", args=(state, batch))
    with ProgramStats(hold=args) as counter:
        new, met = fn(*args)
        counter.outputs((new, met))
    rec = counter.record()
    got = [t.full_tensor() for t in tree_leaves(new.params)]
    loss = float(met["loss"].full_tensor())
    if rank == 0:
        want_state, want_met = make_train_step(
            model, opt, {"remat": "full"}, grad_clip=D.GRAD_CLIP)(state,
                                                                  batch)
        want = tree_leaves(want_state.params)
        scale = max(float(w.abs().max()) for w in want)
        out["param_err"] = max(float((g - w).abs().max())
                               for g, w in zip(got, want)) / scale
        out["loss"], out["want_loss"] = loss, float(want_met["loss"])
        out["moved"] = all(not torch.equal(g, p) for g, p in
                           zip(got, tree_leaves(state.params)))
        out["split"] = [str(p) for p in args[1]["tokens"].placements]

    gcfg = _granite()
    gmodel = build_model(gcfg, "cpu")
    gparams = gmodel.init(torch.Generator().manual_seed(2))
    gbatch = zin.materialize(zin.prefill_specs(gcfg, B, S_MOE), gcfg,
                             seed=3, device="cpu")
    gfn, gargs = D.build_program(
        gcfg, InputShape("debug", S_MOE, B, "prefill"), mesh, True,
        D.make_opts("prefill", True), "cpu", args=(gparams, gbatch))
    logits = gfn(*gargs).full_tensor()
    if rank == 0:
        gwant = make_prefill_step(gmodel)(gparams, gbatch)
        out["logit_err"] = float((logits - gwant).abs().max()) / float(
            gwant.abs().max())
        out["counts"] = {"flops": rec["flops"],
                         "collectives": rec["collectives"],
                         "memory": rec["memory"]}
    return out


def test_sharded_step_on_eight_ranks_matches_unsharded_and_the_fake_run(
        tmp_path):
    o = M.spawn_ranks(_sharded_rank, 8, "cpu", tmpdir=str(tmp_path),
                      timeout_s=600)[0]
    assert o["split"] == ["S(0)", "S(0)", "R"]     # the tokens split
    assert abs(o["loss"] - o["want_loss"]) <= LOSS_RTOL * abs(
        o["want_loss"]), o
    assert o["param_err"] <= PARAM_RTOL, o
    assert o["moved"]
    assert o["logit_err"] <= LOGIT_RTOL, o
    real = o["counts"]
    with M.fake_world(8):
        mesh = M.make_debug_mesh(device="cpu")
        fake = D.measure(_llama(), InputShape("debug", S_TRAIN, B, "train"),
                         mesh, True, D.make_opts("train", True), "cpu")
    assert fake["flops"] == real["flops"] > 0
    assert fake["collectives"] == real["collectives"]
    assert sum(v["count"] for v in fake["collectives"].values()) > 0
    assert fake["memory"]["argument_size_in_bytes"] == \
        real["memory"]["argument_size_in_bytes"]


# -- the moe experts on their shards -----------------------------------------

def _llama4():
    # 16 experts: E splits over the model axis (expert parallel), as
    # llama4-maverick's 128 over 16; the reduced granite's 4 do not, so
    # its experts split their hidden dim, as granite's 40 over 16
    return get_config("llama4-maverick-400b-a17b").reduced().replace(
        num_experts=16)


MOE_CFGS = {"granite": _granite, "llama4": _llama4}


def _moe_program(cfg, mesh, drops):
    """The dry run's train step and prefill of ``cfg`` on real tensors on
    ``mesh``: (loss, params, logits, dropped routes per call)."""
    from repro_torch.models import build_model, inputs as zin
    from repro_torch.training import create_train_state
    from repro_torch.utils.tree import tree_leaves
    model = build_model(cfg, "cpu")
    opts = D.make_opts("train", True)
    state = create_train_state(model.init(torch.Generator().manual_seed(4)),
                               D.optimizer(opts))
    batch = zin.materialize(zin.train_specs(cfg, B, S_MOE), cfg, seed=5,
                            device="cpu")
    drops.clear()
    fn, args = D.build_program(cfg, InputShape("debug", S_MOE, B, "train"),
                               mesh, True, opts, "cpu", args=(state, batch))
    new, met = fn(*args)
    train_drops = list(drops)
    params = model.init(torch.Generator().manual_seed(6))
    pbatch = zin.materialize(zin.prefill_specs(cfg, B, S_MOE), cfg, seed=7,
                             device="cpu")
    drops.clear()
    pfn, pargs = D.build_program(
        cfg, InputShape("debug", S_MOE, B, "prefill"), mesh, True,
        D.make_opts("prefill", True), "cpu", args=(params, pbatch))
    logits = pfn(*pargs).full_tensor()
    return (float(met["loss"].full_tensor()),
            [t.full_tensor() for t in tree_leaves(new.params)], logits,
            (train_drops, list(drops)))


def _moe_rank(rank, world, device):
    """One rank of eight on the debug mesh: the dry run's train step and
    prefill of a reduced moe model on real tensors, its experts on their
    shards, then again with the experts on gathered replicas (the
    replicated dispatch every rank ran before); rank 0 holds loss,
    params, logits and every layer's dropped routes."""
    from repro_torch.kernels.moe_dispatch import ref as mdr
    from repro_torch.sharding import apply as sh
    torch.manual_seed(0)
    mesh = M.make_debug_mesh(device="cpu")
    plain, drops = mdr.slots_ref, []

    def recorded(flat_e, E, C):
        slot, keep, counts = plain(flat_e, E, C)
        drops.append(int((~keep).sum()))
        return slot, keep, counts

    mdr.slots_ref = recorded
    on_shards, out = sh.experts_on_shards, {}
    for name, make in MOE_CFGS.items():
        sh.experts_on_shards = on_shards
        loss, got, logits, got_drops = _moe_program(make(), mesh, drops)
        sh.experts_on_shards = lambda fn, w, x: sh.on_replicas(fn, w, x)
        wloss, want, wlogits, want_drops = _moe_program(make(), mesh, drops)
        if rank != 0:
            continue
        scale = max(float(w.abs().max()) for w in want)
        out[name] = {
            "loss": loss, "want_loss": wloss,
            "param_err": max(float((g - w).abs().max())
                             for g, w in zip(got, want)) / scale,
            "logit_err": float((logits - wlogits).abs().max()) / float(
                wlogits.abs().max()),
            "drops": got_drops, "want_drops": want_drops}
    return out


def test_moe_experts_on_shards_match_the_replicated_dispatch(tmp_path):
    """granite (each expert's hidden dim over the model axis, the partial
    outputs summed) and llama4 at f32 (E over the model axis, the outputs
    gathered) on eight gloo ranks against the same programs with the
    experts on gathered replicas, as every rank ran them before."""
    o = M.spawn_ranks(_moe_rank, 8, "cpu", tmpdir=str(tmp_path),
                      timeout_s=600)[0]
    assert sorted(o) == sorted(MOE_CFGS)
    # the capacity bites somewhere, so the dispatches compared drop routes
    assert sum(sum(r["drops"][1]) for r in o.values()) > 0, o
    for name, r in o.items():
        assert abs(r["loss"] - r["want_loss"]) <= LOSS_RTOL * abs(
            r["want_loss"]), (name, r)
        assert r["param_err"] <= PARAM_RTOL, (name, r)
        assert r["logit_err"] <= LOGIT_RTOL, (name, r)
        assert r["drops"] == r["want_drops"], (name, r)


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
def test_moe_expert_flops_split_over_the_model_axis(name, monkeypatch):
    """Rank 0's FLOPs in the expert FFN on the fake debug mesh are the
    replicated (unsharded) count over the model axis's size."""
    from repro_torch.models import build_model, inputs as zin, moe
    from repro_torch.training.step import make_prefill_step
    from repro_torch.utils.op_stats import ProgramStats
    plain, flops = moe._expert_ffn, []

    def counted(wp, x):
        with ProgramStats() as st:
            y = plain(wp, x)
        flops.append(st.flops)
        return y

    monkeypatch.setattr(moe, "_expert_ffn", counted)
    cfg = MOE_CFGS[name]()
    with M.fake_world(8):
        mesh = M.make_debug_mesh(device="cpu")
        D.measure(cfg, InputShape("debug", S_MOE, B, "prefill"), mesh, True,
                  D.make_opts("prefill", True), "cpu")
    sharded, flops[:] = list(flops), []
    model = build_model(cfg, "cpu")
    with torch.no_grad():
        make_prefill_step(model)(
            model.init(torch.Generator().manual_seed(0)),
            zin.materialize(zin.prefill_specs(cfg, B, S_MOE), cfg, seed=1,
                            device="cpu"))
    assert len(sharded) == len(flops) == cfg.num_layers
    assert all(s * 2 == f > 0 for s, f in zip(sharded, flops)), (sharded,
                                                                 flops)
