"""The port's sweep over ranks (``_run_sweep(mesh=<process group>)``)
against its unsharded sweep, on the CPU.

Two ranks are spawned by ``repro_torch.launch.mesh.spawn_ranks`` (gloo, a
``file://`` rendezvous under ``tmp_path``).  The oracle is the port's own
``_run_sweep(mesh=None)``, which ``test_torch_sweep.py`` holds to the JAX
package's unsharded sweep (the reference's sharded sweep fails in tier-1,
so it is no oracle).  Two seeds split one per rank; three seeds do not
divide two ranks, and every rank runs all three (the reference
replicates).  Every rank returns the whole result.

Tolerances (the CPU's row-independence bounds, ``test_torch_sweep.py``):
counts exact, bytes sent and params bit for bit, test loss 1e-6, accuracy
within one test image (the eval's CPU twins may block their batched
products differently for another number of models).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Experiment  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.sharding.rules import sweep_rows  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)
COUNTS = ("selected", "arrived", "rescued", "delayed", "dropped")


def _spec(seeds):
    base = HSFLConfig(rounds=2, n_uavs=8, k_select=4, n_train=400,
                      n_test=100, steps_per_epoch=2, local_epochs=4)
    return tsweep.SweepSpec(base=base, seeds=seeds,
                            schemes=(("opt", {"b": 2.0}),
                                     ("async", {"b": 1.0}),
                                     ("discard", {"b": 1.0})))


def _sweep_rank(rank, world, device, spec):
    """The panel through the facade on the sweep's group, and through the
    engine with ``mesh="auto"`` (the default group)."""
    torch.set_num_threads(1)
    on_group = Experiment.from_spec(spec).run(
        engine="sweep", mesh=mesh.make_sweep_mesh(), device=device)
    auto = tsweep._run_sweep(spec, mesh="auto", device=device)
    return on_group, auto


def _same_as_unsharded(got, want, n_test):
    assert got.rounds == want.rounds and got.n_programs == want.n_programs
    assert [g.label for g in got.groups] == [g.label for g in want.groups]
    for g, w in zip(got.groups, want.groups):
        assert g.sims == w.sims and g.cfgs == w.cfgs
        for k in COUNTS:
            np.testing.assert_array_equal(g.metrics[k], w.metrics[k],
                                          err_msg=f"{g.label} {k}")
            assert g.metrics[k].dtype == w.metrics[k].dtype
        np.testing.assert_array_equal(g.metrics["bytes_sent"],
                                      w.metrics["bytes_sent"])
        np.testing.assert_allclose(g.metrics["test_loss"],
                                   w.metrics["test_loss"], rtol=1e-6)
        assert np.abs(g.metrics["test_acc"]
                      - w.metrics["test_acc"]).max() <= 1.0 / n_test + 1e-9
        for a, b in zip(tree_leaves(g.final_params),
                        tree_leaves(w.final_params)):
            assert a.shape == b.shape
            assert torch.equal(a.cpu(), b.cpu()), g.label


@pytest.mark.parametrize("seeds", [(0, 1), (0, 1, 2)],
                         ids=["split", "replicated"])
def test_sweep_over_two_ranks_is_the_unsharded_sweep(tmp_path, seeds):
    spec = _spec(seeds)
    want = tsweep._run_sweep(spec, mesh=None, device="cpu")
    ranks = mesh.spawn_ranks(_sweep_rank, 2, "cpu", args=(spec,),
                             tmpdir=str(tmp_path))
    for on_group, auto in ranks:
        _same_as_unsharded(on_group, want, spec.base.n_test)
        _same_as_unsharded(auto, want, spec.base.n_test)


@pytest.mark.parametrize("n,world,rank,want", [
    (2, 2, 0, (0, 1)), (2, 2, 1, (1, 2)), (6, 3, 2, (4, 6)),
    (3, 2, 1, (0, 3)), (4, 1, 0, (0, 4)), (1, 2, 1, (0, 1))])
def test_sweep_rows(n, world, rank, want):
    assert sweep_rows(n, world, rank) == want


def test_sweep_rows_refuses_a_rank_outside_the_world():
    with pytest.raises(ValueError, match="not in a world of 2"):
        sweep_rows(2, 2, 2)


def test_mesh_takes_none_auto_or_a_process_group():
    spec = _spec((0,))
    # no process group: "auto" is one device, as None is
    a = tsweep._run_sweep(spec, mesh="auto", device="cpu")
    b = tsweep._run_sweep(spec, mesh=None, device="cpu")
    for g, w in zip(a.groups, b.groups):
        for k in COUNTS:
            np.testing.assert_array_equal(g.metrics[k], w.metrics[k])
    for bad in (object(), "pod", 2):
        with pytest.raises(TypeError, match="make_sweep_mesh"):
            tsweep._run_sweep(spec, mesh=bad, device="cpu")
