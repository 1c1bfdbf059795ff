"""The check that decides ``correct``, at test size on the CPU: sound runs
pass; the control (each reference in the precision below its
configuration's) fails; and a run with the timed path broken underneath
comes out not correct, once for each fault the cells can have (a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced, and in FL a round's aggregate not carried
to the next; neither cell has an exchange between chips).  The faults
are ``faults.py``'s, which ``calibrate.py`` reads at each cell's size."""
import numpy as np
import pytest

from perfbench import faults, harness, testing


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.make_tiny_root(tmp_path_factory.mktemp("checks"))


def _driver(root, cell, seed):
    bench = harness.Benchmark(root)
    c = bench.cell(cell)
    traffic = bench.traffic(c["traffic"])
    ctx = harness.Context(root=bench.root, cell=c,
                          config=bench.config(c["config"]), traffic=traffic,
                          seed=seed, device="cpu",
                          work=bench.work(c["config"]),
                          reference=bench.reference(c["config"]), peaks={})
    drv = bench.driver(traffic["driver"]).Driver(ctx)
    drv.setup()
    return drv, traffic["limits"][c["config"]]


@pytest.mark.parametrize("cell", ["tiny-fl", "tiny-prefill"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_sound_runs_are_correct(root, cell, seed):
    out = harness.run_cell(cell, seed, 0.0, False, "cpu", root)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["tiny-fl", "tiny-prefill"])
def test_the_control_is_not_correct(root, cell):
    drv, limits = _driver(root, cell, 21)
    got = drv.readings(control=True)
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items()), got


FAULTS = {
    ("tiny-fl", "unchanged"): ("fl_sweep", "unchanged"),
    ("tiny-fl", "half"): ("fl_sweep", "half"),
    ("tiny-fl", "stale"): ("fl_sweep", "stale"),
    ("tiny-fl", "altered"): ("fl_sweep", "altered"),
    ("tiny-prefill", "unchanged"): ("prefill", "unchanged"),
    ("tiny-prefill", "half"): ("prefill", "half"),
    ("tiny-prefill", "altered"): ("prefill", "unwritten"),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    driver, kind = FAULTS[(cell, fault)]
    module, attr, broken = faults.FAULTS[driver][kind]()
    monkeypatch.setattr(module, attr, broken)
    out = harness.run_cell(cell, 5, 0.0, False, "cpu", root)
    assert not out["correct"], out["checks"]


def test_nan_fails_every_limit():
    from perfbench.drivers import fl_sweep
    assert fl_sweep._worst([0.0, np.nan]) == float("inf")
