"""The port's span-and-counter recorder (``repro_torch.utils.trace``) and
the spans the sweep, the round and the prefill place with it.

- Off, ``span`` is one shared object and nothing is kept.
- On, a sweep has one ``sweep.rounds`` span a group with ``rounds``
  ``round`` spans under it, each with ``local_epochs`` ``round.epoch``
  spans, parents right; a Granite prefill has ``num_layers`` x
  ``moe.dispatch``/``moe.experts``/``moe.combine`` under ``prefill.step``;
  ``moe.routes`` is layers·B·S·k, ``moe.dropped_routes`` the capacity
  drops the slots give and ``moe.dispatch_kernel`` one a layer
  call that takes the dispatch kernels.
- Recording changes no number: the sweep's metrics and params and the
  prefill's logits are bitwise those of an unrecorded run.
On the CPU every span is a host span (``device_ms`` None).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import sweep as tsweep
from repro_torch.core.hsfl import HSFLConfig
from repro_torch.kernels.moe_dispatch.ref import slots_ref
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.training.step import make_prefill_step
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

# the benchmark's test sizes (perfbench/testing.py), 3 rounds
TINY_CNN = dict(rounds=3, n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=4)


def _children(rec, parent, name=None):
    return [s for s in rec.spans if s.parent == parent
            and (name is None or s.name == name)]


def test_off_span_is_one_shared_object_and_keeps_nothing():
    assert not trace.active()
    a, b = trace.span("x"), trace.span("y", device=torch.zeros(1))
    assert a is b
    with a:
        trace.count("c", 3)
    with trace.record() as rec:
        assert trace.active()
        with trace.span("kept"):
            pass
    assert not trace.active()
    assert [s.name for s in rec.spans] == ["kept"] and rec.counters == {}


def test_spans_nest_counters_add_and_recordings_do_not_nest():
    with trace.record() as rec:
        with trace.span("a"):
            with trace.span("b", device=torch.ones(2)):
                trace.count("n", 2)
                trace.count("n", torch.tensor(3))
            with trace.span("c"):
                trace.count("m", 1.5)
        with pytest.raises(RuntimeError):
            with trace.record():
                pass
    a, b, c = rec.spans
    assert (a.name, a.parent) == ("a", -1)
    assert (b.name, b.parent, c.name, c.parent) == ("b", a.id, "c", a.id)
    assert a.t0_ns <= b.t0_ns <= b.t1_ns <= c.t0_ns <= c.t1_ns <= a.t1_ns
    assert all(s.device_ms is None for s in rec.spans)    # CPU tensors
    assert rec.counters == {"n": 5, "m": 1.5}


def _sweep(record: bool):
    spec = tsweep.SweepSpec(base=HSFLConfig(**TINY_CNN), seeds=(0, 1),
                            b=(1.0, 2.0, 3.0),
                            schemes=(("opt", {}), ("discard", {"b": 1.0})))
    if not record:
        return tsweep._run_sweep(spec, device="cpu"), None
    with trace.record() as rec:
        res = tsweep._run_sweep(spec, device="cpu")
    return res, rec


@pytest.fixture(scope="module")
def sweeps():
    return _sweep(False)[0], _sweep(True)


def test_sweep_spans_and_their_parents(sweeps):
    _, (res, rec) = sweeps
    groups, rounds, epochs = len(res.groups), res.rounds, 4
    roots = [s for s in rec.spans if s.parent == -1]
    assert [s.name for s in roots] == [
        "sweep.program", "sweep.sim_arrays", "sweep.group_inputs",
        "sweep.rounds", "sweep.read",
        "sweep.group_inputs", "sweep.rounds", "sweep.read"]
    loops = [s for s in roots if s.name == "sweep.rounds"]
    assert len(loops) == groups == 2
    for loop in loops:
        per_round = _children(rec, loop.id)
        assert [s.name for s in per_round] == ["round"] * rounds
        for r in per_round:
            names = [s.name for s in _children(rec, r.id)]
            assert names == (["round.schedule"] + ["round.epoch"] * epochs
                             + ["round.final", "round.aggregate",
                                "round.eval"])
            for ep in _children(rec, r.id, "round.epoch"):
                assert [s.name for s in _children(rec, ep.id)] == [
                    "round.train", "round.probe"]
    assert len([s for s in rec.spans if s.name == "round"]) == \
        groups * rounds
    # the loop and the read lie inside the group's run_s
    for g, loop in zip(res.groups, loops):
        read = next(s for s in roots if s.name == "sweep.read"
                    and s.t0_ns >= loop.t1_ns)
        assert (loop.t1_ns - loop.t0_ns + read.t1_ns - read.t0_ns) / 1e9 \
            <= g.run_s + 1e-3


def test_recording_changes_no_sweep_number(sweeps):
    off, (on, _) = sweeps
    for g_off, g_on in zip(off.groups, on.groups):
        for key in g_off.metrics:
            np.testing.assert_array_equal(g_on.metrics[key],
                                          g_off.metrics[key])
        for a, b in zip(tree_leaves(g_on.final_params),
                        tree_leaves(g_off.final_params)):
            assert torch.equal(a, b)


def _granite():
    cfg = configs.get_config("granite-moe-3b-a800m").reduced().replace(
        dtype="bfloat16")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (3, 32),
                           generator=torch.Generator().manual_seed(4))
    return cfg, make_prefill_step(model), params, tokens


def test_prefill_spans_counters_and_logits():
    cfg, step, params, tokens = _granite()
    want = step(params, {"tokens": tokens})
    with trace.record() as rec:
        got = step(params, {"tokens": tokens})
    assert torch.equal(got, want)
    (root,) = [s for s in rec.spans if s.parent == -1]
    assert root.name == "prefill.step"
    top = [s.name for s in _children(rec, root.id)]
    L = cfg.num_layers
    assert top == (["model.embed"] + ["layer.attention", "layer.ffn"] * L
                   + ["model.head"])
    for ffn in _children(rec, root.id, "layer.ffn"):
        stages = _children(rec, ffn.id)
        assert [s.name for s in stages] == ["moe.dispatch", "moe.experts",
                                            "moe.combine"]
        assert [s.name for s in _children(rec, stages[0].id)] == \
            ["moe.route"]
    B, S = tokens.shape
    assert rec.counters["moe.routes"] == L * B * S * cfg.experts_per_token
    assert rec.counters["moe.dropped_routes"] >= 0


def test_dropped_routes_count_the_capacity_drops():
    """A zero router ties every expert, so every token routes to experts
    0..k-1 and all but the first C of each are dropped."""
    cfg = configs.get_config("granite-moe-3b-a800m").reduced()
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    p = {**p, "router": torch.zeros_like(p["router"])}
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    T, k, E = 128, cfg.experts_per_token, cfg.num_experts
    C = moe.capacity(T, cfg)
    _, keep, _ = slots_ref(torch.arange(k).repeat(T), E, C)
    want = int((~keep).sum())
    assert want > 0
    y0, _ = moe.moe_ffn(p, cfg, x)
    with trace.record() as rec:
        y1, _ = moe.moe_ffn(p, cfg, x)
    assert torch.equal(y0, y1)
    assert rec.counters == {"moe.routes": T * k, "moe.dropped_routes": want,
                            "moe.dispatch_kernel": 1}
