"""The twins of ``examples/*.py`` (``repro_torch.examples``) on the CPU:
each runs to its end through its ``main`` with ``--device cpu`` and prints
its closing line.  ``uav_fl_sim`` runs its three modes: the sweep panel,
the loop engine with the codec, and the aggregation service under the
im2col policy.  ``opportunistic_multipod`` spawns its four pods as gloo
ranks on the CPU.  The engines they drive are held to the JAX package by
their own tests (``test_torch_sweep.py``, ``test_torch_serving.py``,
``test_torch_training.py``, ``test_torch_opp_sync.py``).
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("serve_batched", []),
    ("uav_fl_sim", ["--rounds", "2"]),
    ("uav_fl_sim", ["--rounds", "2", "--engine", "loop", "--codec",
                    "--schemes", "opt=2"]),
    ("uav_fl_sim", ["--rounds", "2", "--serve", "--kernel", "im2col"]),
    ("opportunistic_multipod", ["--rounds", "2"])])
def test_example_twins_run_on_the_cpu(name, argv, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert {"quickstart": "quickstart OK", "serve_batched": "serving OK",
            "uav_fl_sim": "===",
            "opportunistic_multipod": "OpportunisticSync OK"}[name] in out
