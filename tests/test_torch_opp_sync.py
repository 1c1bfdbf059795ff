"""The port's OpportunisticSync (``repro_torch.core.opportunistic_sync``)
against the JAX package's, on the CPU.

Pods are ranks spawned by ``repro_torch.launch.mesh.spawn_ranks`` (gloo on
the CPU, a ``file://`` rendezvous under ``tmp_path``).  The oracle of the
round is the unsharded composition of the reference's functions: per pod,
its jitted ``train_step`` then its jitted ``maybe_snapshot`` at each inner
step, then ``round_sync`` under ``jax.vmap(..., axis_name="pod")``.  The
reference's own four-pod ``shard_map`` test fails in its set-up
(``jnp.broadcast_to`` under ``use_mesh``), so it is not used.

Tolerances:
- the schedule, ``tau_extra0``, every snapshot decision, ``snapshot_step``
  and ``tau_extra``: exact (the same f32 operations);
- ``pod_contribution``: exact;
- ``round_sync``: 1e-6 relative (a sum of 2 or 4 pods in another order);
- a round of ``make_opp_sync_round``, each from the JAX state at its start
  (f32 trajectories fork): loss 1e-5 relative, params 1e-4 of the largest
  magnitude (the zoo's training bounds);
- ``channel_trace``'s outage share: within 5 standard deviations of the
  binomial's mean.
"""
import datetime
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.configs import base as j_configs  # noqa: E402
from repro.core import opportunistic_sync as jos  # noqa: E402
from repro.core.schemes import get_scheme as j_get_scheme  # noqa: E402
from repro.core.schemes import registered_schemes as j_registered  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.training import create_train_state as j_create_state  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro.training.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import opportunistic_sync as tos  # noqa: E402
from repro_torch.core.schemes import get_scheme, registered_schemes  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

SYNC_RTOL = 1e-6
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4


def _cfgs(**kw):
    return jos.OppSyncConfig(**kw), tos.OppSyncConfig(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# one pod, no collective
# ---------------------------------------------------------------------------

GRID = list(itertools.product((4, 6, 8), (1, 2, 3, 4)))


@pytest.mark.parametrize("e,b", GRID)
def test_schedule_allowance_and_snapshots_match_jax(e, b):
    """``is_scheduled`` over a round, ``tau_extra0`` and a pod's
    ``maybe_snapshot`` decisions over 3 rounds of drawn rates and outages,
    exactly."""
    jcfg, tcfg = _cfgs(inner_steps=e, budget=b, payload=1.5, rate0=0.8,
                       outage_prob=0.4)
    assert tcfg.tau_extra0 == jcfg.tau_extra0
    assert tcfg.schedule_period() == jcfg.schedule_period()
    for i in range(e + 2):
        assert bool(tos.is_scheduled(tcfg, torch.tensor(i))) == \
            bool(jos.is_scheduled(jcfg, jnp.asarray(i)))
    rng = np.random.default_rng(10 * e + b)
    n = 3 * e
    rates = (0.8 * np.exp(0.5 * rng.standard_normal(n))).astype(np.float32)
    rates[::5] = 0.0                              # τ = payload / 1e-9
    outages = rng.random(n) < 0.4
    p = {"w": rng.standard_normal((2, 3)).astype(np.float32)}
    js = JTrainState(params=p, opt_state=(), step=jnp.asarray(0, jnp.int32),
                     snapshot={"w": np.zeros((2, 3), np.float32)},
                     snapshot_step=jnp.asarray(-1, jnp.int32),
                     tau_extra=jnp.asarray(jcfg.tau_extra0, jnp.float32))
    ts = state_from_numpy(_np(js), "cpu")
    jsnap = jax.jit(lambda st, r, o: jos.maybe_snapshot(jcfg, st, r, o))
    for t in range(n):
        if t % e == 0:                            # a round boundary resets
            js = js._replace(tau_extra=jnp.asarray(jcfg.tau_extra0,
                                                   jnp.float32))
            ts = ts._replace(tau_extra=torch.tensor(tcfg.tau_extra0))
        p = {"w": p["w"] + 1.0}                   # a train step's new params
        js = js._replace(params=p, step=js.step + 1)
        ts = ts._replace(params={"w": torch.tensor(p["w"])},
                         step=ts.step + 1)
        js = jsnap(js, rates[t], outages[t])
        ts = tos.maybe_snapshot(tcfg, ts, torch.tensor(rates[t]),
                                torch.tensor(outages[t]))
        assert int(ts.snapshot_step) == int(js.snapshot_step)
        assert np.float32(ts.tau_extra) == np.float32(js.tau_extra)
        np.testing.assert_array_equal(ts.snapshot["w"].numpy(),
                                      np.asarray(js.snapshot["w"]))


@pytest.mark.parametrize("name", registered_schemes())
def test_pod_contribution_matches_jax(name):
    """Every registered scheme's per-pod payload and weight, over every
    (arrived, have_snap) case, exactly."""
    assert registered_schemes() == j_registered()
    rng = np.random.default_rng(1)
    p = {"a": rng.standard_normal(3).astype(np.float32),
         "b": rng.standard_normal((2, 2)).astype(np.float32)}
    s = {k: v + 1.0 for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tsn = {k: torch.tensor(v) for k, v in s.items()}
    for arrived, have in itertools.product((False, True), repeat=2):
        jc, jv = j_get_scheme(name).pod_contribution(
            p, s, jnp.asarray(have), jnp.asarray(arrived), alpha=0.3, a=0.7)
        tc, tv = get_scheme(name).pod_contribution(
            tp, tsn, torch.tensor(have), torch.tensor(arrived), alpha=0.3,
            a=0.7)
        assert tv.dtype == torch.float32 and tv.shape == ()
        assert np.float32(tv) == np.float32(jv)
        for k in p:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


# ---------------------------------------------------------------------------
# round_sync over spawned ranks
# ---------------------------------------------------------------------------

def _sync_cases(n_pods: int):
    """(scheme, params, snapshots, snapshot_step, arrived) per pod."""
    rng = np.random.default_rng(n_pods)

    def pods():
        return {"w": rng.standard_normal((n_pods, 3, 5)).astype(np.float32),
                "b": rng.standard_normal((n_pods, 7)).astype(np.float32)}
    mixed = np.arange(n_pods) % 2 == 0
    have = np.where(np.arange(n_pods) % 4 < 2, 3, -1).astype(np.int32)
    cases = [(name, pods(), pods(), have, mixed)
             for name in registered_schemes()]
    none = np.zeros(n_pods, bool)
    cases += [
        # every pod delayed under async: 0 < Σ valid < 1 (the reference's
        # fractional-weight regression)
        ("async", pods(), pods(), np.full(n_pods, -1, np.int32), none),
        # the empty round: no final, no snapshot
        ("opt", pods(), pods(), np.full(n_pods, -1, np.int32), none),
        ("discard", pods(), pods(), have, none),
        # only snapshots rescue
        ("opt", pods(), pods(), np.full(n_pods, 2, np.int32), none)]
    return cases


# the cases of _sync_cases in which no pod is valid
_EMPTY = (len(registered_schemes()) + 1, len(registered_schemes()) + 2)


def _sync_rank(rank, world, device, cases, bucket_elems):
    tos.BUCKET_ELEMS = bucket_elems                # this process only
    out = []
    for name, params, snaps, sstep, arrived in cases:
        cfg = tos.OppSyncConfig(scheme=name)
        state = TrainState(
            params={k: torch.tensor(v[rank]) for k, v in params.items()},
            opt_state={}, step=torch.tensor(4, dtype=torch.int32),
            snapshot={k: torch.tensor(v[rank]) for k, v in snaps.items()},
            snapshot_step=torch.tensor(sstep[rank]),
            tau_extra=torch.tensor(0.25))
        new = tos.round_sync(cfg, state, torch.tensor(arrived[rank]))
        out.append(state_to_numpy(new))
    return out


@pytest.mark.parametrize("n_pods,bucket_elems", [(2, 7), (4, 1 << 20)])
def test_round_sync_matches_jax(tmp_path, n_pods, bucket_elems):
    """Every scheme on mixed arrivals, the all-delayed async round, the
    empty round and snapshot-only rescues; 7-element buckets split the
    leaves across all-reduces."""
    cases = _sync_cases(n_pods)
    got = mesh.spawn_ranks(_sync_rank, n_pods, "cpu",
                           args=(cases, bucket_elems), tmpdir=str(tmp_path))
    for i, (name, params, snaps, sstep, arrived) in enumerate(cases):
        cfg = jos.OppSyncConfig(scheme=name)
        st = JTrainState(
            params=params, opt_state=(),
            step=jnp.full((n_pods,), 4, jnp.int32), snapshot=snaps,
            snapshot_step=jnp.asarray(sstep),
            tau_extra=jnp.full((n_pods,), 0.25, jnp.float32))
        want = jax.vmap(lambda s, a: jos.round_sync(cfg, s, a),
                        axis_name="pod")(st, jnp.asarray(arrived))
        for pod in range(n_pods):
            new = got[pod][i]
            assert int(new.snapshot_step) == -1
            assert np.float32(new.tau_extra) == np.float32(cfg.tau_extra0)
            for k in params:
                w = np.asarray(want.params[k][pod])
                np.testing.assert_allclose(new.params[k], w,
                                           rtol=SYNC_RTOL, atol=1e-7,
                                           err_msg=f"{name} case {i}")
                np.testing.assert_array_equal(new.snapshot[k], new.params[k])
                if i not in _EMPTY:               # the pods agree bit for bit
                    np.testing.assert_array_equal(new.params[k],
                                                  got[0][i].params[k])
        if i in _EMPTY:
            for k in params:                      # nothing valid: unchanged
                np.testing.assert_array_equal(
                    np.stack([got[p][i].params[k] for p in range(n_pods)]),
                    params[k])


def _bf16_sync_rank(rank, world, device, cases):
    """``round_sync`` with the ``w`` leaves in bf16: per case, each leaf's
    dtype and its values in f32."""
    out = []
    for name, params, snaps, sstep, arrived in cases:
        def tree(leaves):
            return {k: torch.tensor(v[rank]).to(
                torch.bfloat16 if k == "w" else torch.float32)
                for k, v in leaves.items()}
        state = TrainState(
            params=tree(params), opt_state={},
            step=torch.tensor(4, dtype=torch.int32), snapshot=tree(snaps),
            snapshot_step=torch.tensor(sstep[rank]),
            tau_extra=torch.tensor(0.25))
        new = tos.round_sync(tos.OppSyncConfig(scheme=name), state,
                             torch.tensor(arrived[rank]))
        out.append({k: (str(v.dtype), v.float().numpy())
                    for k, v in new.params.items()})
    return out


def test_round_sync_keeps_bf16_leaves(tmp_path):
    """A bf16 leaf comes back in bf16 under every scheme, within a bf16
    rounding of the reference's value; the f32 leaf as before.  The
    reference gives the same inputs' bf16 leaf back in f32 under every
    scheme but async (jnp's promotion of ``x * valid``); async keeps bf16
    there and sums in it.  Bound: 2**-7 of the largest input magnitude
    (the port rounds its f32 mean once; async's bf16 products and sum add
    up to a few roundings of the terms)."""
    n_pods = 2
    cases = _sync_cases(n_pods)
    for _, params, snaps, _, _ in cases:
        for leaves in (params, snaps):     # inputs exact in bf16 on both sides
            leaves["w"] = np.asarray(jnp.asarray(leaves["w"], jnp.bfloat16),
                                     np.float32)
    got = mesh.spawn_ranks(_bf16_sync_rank, n_pods, "cpu", args=(cases,),
                           tmpdir=str(tmp_path))
    for i, (name, params, snaps, sstep, arrived) in enumerate(cases):
        cfg = jos.OppSyncConfig(scheme=name)

        def tree(leaves):
            return {k: jnp.asarray(v, jnp.bfloat16 if k == "w"
                                   else jnp.float32)
                    for k, v in leaves.items()}
        st = JTrainState(
            params=tree(params), opt_state=(),
            step=jnp.full((n_pods,), 4, jnp.int32), snapshot=tree(snaps),
            snapshot_step=jnp.asarray(sstep),
            tau_extra=jnp.full((n_pods,), 0.25, jnp.float32))
        want = jax.vmap(lambda s, a: jos.round_sync(cfg, s, a),
                        axis_name="pod")(st, jnp.asarray(arrived))
        for pod in range(n_pods):
            dtype, w = got[pod][i]["w"]
            assert dtype == "torch.bfloat16", f"{name} case {i}"
            assert got[pod][i]["b"][0] == "torch.float32"
            scale = max(np.abs(params["w"]).max(), np.abs(snaps["w"]).max())
            np.testing.assert_allclose(
                w, np.asarray(want.params["w"][pod], np.float32),
                rtol=0, atol=2 ** -7 * scale, err_msg=f"{name} case {i}")
            np.testing.assert_allclose(
                got[pod][i]["b"][1], np.asarray(want.params["b"][pod]),
                rtol=SYNC_RTOL, atol=1e-7, err_msg=f"{name} case {i}")


# ---------------------------------------------------------------------------
# make_opp_sync_round on 4 ranks vs the unsharded JAX composition
# ---------------------------------------------------------------------------

N_PODS, ROUNDS, B, S = 4, 2, 2, 16


def _arch():
    return configs.get_config("llama3.2-1b").reduced()


def _record(train_step, seen):
    """``train_step`` that first records the pod's snapshot slots: at the
    entry of step t they hold the decisions of steps 0 .. t-1."""
    def step(state, batch):
        seen.append((int(state.snapshot_step), float(state.tau_extra)))
        return train_step(state, batch)
    return step


def _round_rank(rank, world, device, cfg_kw, rounds):
    cfg = tos.OppSyncConfig(**cfg_kw)
    model = build_model(_arch(), device)
    seen = []
    one_round = tos.make_opp_sync_round(
        cfg, _record(make_train_step(model, sgd(1e-2)), seen))
    out = []
    for start, batches, rates, outages, arrived in rounds:
        seen.clear()
        state = state_from_numpy(
            jax.tree_util.tree_map(lambda a: a[rank], start), device)
        new, losses = one_round(
            state, {k: torch.tensor(v[rank]) for k, v in batches.items()},
            torch.tensor(rates), torch.tensor(outages), torch.tensor(arrived))
        out.append((state_to_numpy(new), losses.numpy(), list(seen)))
    return out


def _jax_rounds(cfg_kw):
    """The unsharded JAX composition over ROUNDS rounds: each round's start
    state (stacked over pods), batches, trace slices, and its per-pod
    losses, decisions and end state."""
    jcfg = jos.OppSyncConfig(**cfg_kw)
    model = j_build_model(j_configs.ModelConfig(**vars(_arch())))
    opt = j_optim.sgd(1e-2)
    step = jax.jit(j_make_train_step(model, opt))
    snap = jax.jit(lambda st, r, o: jos.maybe_snapshot(jcfg, st, r, o))
    sync = jax.jit(jax.vmap(lambda st, a: jos.round_sync(jcfg, st, a),
                            axis_name="pod"))
    state0 = j_create_state(model.init(jax.random.PRNGKey(0)), opt,
                            with_opt_sync=True, tau_extra0=jcfg.tau_extra0)
    stacked = jax.tree_util.tree_map(
        lambda a: jnp.stack([a] * N_PODS), state0)
    rates, outages, arrived = _np(jos.channel_trace(
        jcfg, jax.random.PRNGKey(1), N_PODS, ROUNDS))
    rng = np.random.default_rng(0)
    e, v = jcfg.inner_steps, model.cfg.vocab_size
    inputs, want = [], []
    for r in range(ROUNDS):
        batches = {k: rng.integers(0, v, (N_PODS, e, B, S)).astype(np.int32)
                   for k in ("tokens", "labels")}
        inputs.append((_np(stacked), batches, rates[r], outages[r],
                       arrived[r]))
        pods, losses, seen = [], [], []
        for p in range(N_PODS):
            st = jax.tree_util.tree_map(lambda a: a[p], stacked)
            ls, sn = [], [(int(st.snapshot_step), float(st.tau_extra))]
            for t in range(e):
                st, m = step(st, {k: b[p, t] for k, b in batches.items()})
                st = snap(st, rates[r][t, p], outages[r][t, p])
                ls.append(float(m["loss"]))
                sn.append((int(st.snapshot_step), float(st.tau_extra)))
            # the final step (inner index 0) is never scheduled
            assert sn[-1] == sn[-2]
            pods.append(st)
            losses.append(ls)
            seen.append(sn[:e])
        stacked = sync(jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pods),
                       jnp.asarray(arrived[r]))
        want.append((_np(stacked), np.asarray(losses), seen))
    return inputs, want


def test_round_matches_the_unsharded_jax_composition(tmp_path):
    cfg_kw = dict(inner_steps=4, budget=2, outage_prob=0.5, rate0=1.0)
    inputs, want = _jax_rounds(cfg_kw)
    got = mesh.spawn_ranks(_round_rank, N_PODS, "cpu", args=(cfg_kw, inputs),
                           tmpdir=str(tmp_path))
    n_snap = 0
    for r in range(ROUNDS):
        end, losses, seen = want[r]
        for p in range(N_PODS):
            st, ls, sn = got[p][r]
            assert ls.shape == (cfg_kw["inner_steps"],)
            np.testing.assert_allclose(ls, losses[p], rtol=LOSS_RTOL)
            assert sn == seen[p], f"round {r} pod {p} decisions"
            n_snap += sum(a[0] >= 0 for a in sn)
            assert int(st.snapshot_step) == int(end.snapshot_step[p]) == -1
            assert np.float32(st.tau_extra) == np.float32(end.tau_extra[p])
            jp = jax.tree_util.tree_map(lambda a: a[p], end.params)
            scale = max(float(np.abs(a).max()) for a in tree_leaves(jp))
            for a, b in zip(tree_leaves(st.params), tree_leaves(jp)):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=PARAM_RTOL * scale)
            for a, b in zip(tree_leaves(st.params),
                            tree_leaves(got[0][r][0].params)):
                np.testing.assert_array_equal(a, b)
    assert n_snap > 0                         # the trace took a snapshot


# ---------------------------------------------------------------------------
# the trace, the backend rule, the refusals
# ---------------------------------------------------------------------------

def test_channel_trace_shapes_bits_and_outage_share():
    cfg = tos.OppSyncConfig(inner_steps=6, outage_prob=0.3, rate0=2.0)
    rates, outages, arrived = tos.channel_trace(
        cfg, torch.Generator().manual_seed(3), 4, 50)
    assert rates.shape == outages.shape == (50, 7, 4)
    assert arrived.shape == (50, 4) and arrived.dtype == torch.bool
    assert torch.equal(arrived, ~outages[:, -1, :])
    assert rates.dtype == torch.float32 and bool((rates > 0).all())
    again = tos.channel_trace(cfg, torch.Generator().manual_seed(3), 4, 50)
    for a, b in zip((rates, outages, arrived), again):
        assert torch.equal(a, b)
    other = tos.channel_trace(cfg, torch.Generator().manual_seed(4), 4, 50)
    assert not torch.equal(rates, other[0])
    n, p = outages.numel(), cfg.outage_prob
    assert abs(float(outages.sum()) - n * p) < 5 * (n * p * (1 - p)) ** 0.5
    # log-normal around rate0: the median of rate / rate0 is 1
    assert abs(float((rates / 2.0).log().median())) < 0.1


@pytest.mark.parametrize("world,cards,kind,want", [
    (4, 1, "cuda", "gloo"), (2, 1, "cuda", "gloo"), (2, 2, "cuda", "nccl"),
    (4, 8, "cuda", "nccl"), (1, 1, "cuda", "nccl"), (4, 0, "cpu", "gloo"),
    (1, 0, "cpu", "gloo")])
def test_backend_rule(world, cards, kind, want):
    assert mesh.backend_for(world, cards, kind) == want


def test_backend_rule_refuses_other_devices():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mesh.backend_for(2, 0, "meta")


def _tiny_state(device):
    params = {"w": torch.zeros(2, 3, device=device)}
    return TrainState(params=params, opt_state={},
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      snapshot={"w": torch.zeros(2, 3, device=device)},
                      snapshot_step=torch.full((), -1, dtype=torch.int32,
                                               device=device),
                      tau_extra=torch.zeros((), device=device))


def _round_args(cfg, n_pods=1):
    e = cfg.inner_steps
    return ({"tokens": torch.zeros(e, 1, 2, dtype=torch.int32)},
            torch.ones(e + 1, n_pods), torch.zeros(e + 1, n_pods, dtype=bool),
            torch.ones(n_pods, dtype=bool))


def test_round_refuses_without_a_process_group_or_on_the_wrong_device(
        tmp_path):
    cfg = tos.OppSyncConfig(inner_steps=2)
    never = lambda st, b: pytest.fail("the step ran")  # noqa: E731
    one_round = tos.make_opp_sync_round(cfg, never)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        one_round(_tiny_state("cpu"), *_round_args(cfg))
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        mesh.make_sweep_mesh()
    # a one-rank world in this process, torn down at the end
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            one_round(_tiny_state("meta"), *_round_args(cfg))
        mixed = _tiny_state("cpu")._replace(
            snapshot={"w": torch.zeros(2, 3, device="meta")})
        with pytest.raises(ValueError, match="spans devices"):
            one_round(mixed, *_round_args(cfg))
        with pytest.raises(ValueError, match=r"must be \(3, 1\)"):
            one_round(_tiny_state("cpu"), *_round_args(cfg, n_pods=2))
        assert mesh.make_pod_group() is dist.group.WORLD
        with pytest.raises(ValueError, match="2 ranks asked of a world of 1"):
            mesh.make_sweep_mesh(2)
    finally:
        dist.destroy_process_group()


def test_spawned_rank_failure_raises_in_the_parent(tmp_path):
    """Rank 1 raises while rank 0 would run for a minute: the parent
    stops rank 0 and raises rank 1's error."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="pod 1 fails"):
        mesh.spawn_ranks(_failing_rank, 2, "cpu", tmpdir=str(tmp_path))
    assert time.monotonic() - t0 < 50


def _failing_rank(rank, world, device):
    if rank == 1:
        raise RuntimeError("pod 1 fails")
    time.sleep(60)
