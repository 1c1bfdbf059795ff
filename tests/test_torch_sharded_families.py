"""The dry run's train program for the ssm and hybrid families on real
ranks: eight gloo ranks on ``make_debug_mesh()`` (2 x 2 x 2) run reduced
RWKV6-7B and hymba-1.5b train steps (AdamW, remat full, clip 1.0), the
batch split over pod x data, against the port's unsharded step from the
same state (already held to JAX in ``test_torch_training.py``): loss
within 1e-5 relative, params within 1e-4 of the largest magnitude.

These programs run their recurrences on each rank's shards
(``sharding.apply.split_map``): the WKV scan and its decode step, mamba's
conv and selective scan.  A param that a split does not cover (RWKV's
``bonus_u`` beside split heads, mamba's ``A`` and ``D``) gets a partial
gradient on each rank; the check fails if those are not summed.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

ARCHS = ("rwkv6-7b", "hymba-1.5b")
B, S = 32, 64
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4


def _cfg(arch):
    cfg = get_config(arch).reduced()
    return cfg if cfg.family == "ssm" else cfg.replace(num_kv_heads=2)


def _rank(rank, world, device):
    from repro_torch.models import build_model, inputs as zin
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves
    mesh = M.make_debug_mesh(device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg, "cpu")
        opts = D.make_opts("train", True)
        opt = D.optimizer(opts)
        state = create_train_state(
            model.init(torch.Generator().manual_seed(0)), opt)
        batch = zin.materialize(zin.train_specs(cfg, B, S), cfg, seed=1,
                                device="cpu")
        fn, args = D.build_program(cfg, InputShape("debug", S, B, "train"),
                                   mesh, True, opts, "cpu",
                                   args=(state, batch))
        new, met = fn(*args)
        got = [t.full_tensor() for t in tree_leaves(new.params)]
        loss = float(met["loss"].full_tensor())
        if rank:
            continue
        want_state, want_met = make_train_step(
            model, opt, {"remat": "full"}, grad_clip=D.GRAD_CLIP)(state,
                                                                  batch)
        want = tree_leaves(want_state.params)
        scale = max(float(w.abs().max()) for w in want)
        out[arch] = {
            "loss": loss, "want_loss": float(want_met["loss"]),
            "param_err": max(float((g - w).abs().max())
                             for g, w in zip(got, want)) / scale,
            "split": [str(p) for p in args[1]["tokens"].placements]}
    return out


def test_ssm_and_hybrid_train_steps_on_eight_ranks(tmp_path):
    out = M.spawn_ranks(_rank, 8, "cpu", tmpdir=str(tmp_path),
                        timeout_s=600)[0]
    for arch in ARCHS:
        o = out[arch]
        assert o["split"] == ["S(0)", "S(0)", "R"], arch
        assert abs(o["loss"] - o["want_loss"]) <= LOSS_RTOL * abs(
            o["want_loss"]), (arch, o)
        assert o["param_err"] <= PARAM_RTOL, (arch, o)
