"""Tiny cells for the CPU tests: a copy of ``perfbench/`` in a temporary
root with one FL cell and one prefill cell at sizes a test can hold, each
reading the real configuration's files under a new name."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

TINY_CNN = dict(n_uavs=8, k_select=4, n_train=400, n_test=100,
                steps_per_epoch=2, local_epochs=4)
TINY_GRANITE = dict(hidden_size=64, intermediate_size=32,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, num_local_experts=4,
                    num_experts_per_tok=2, vocab_size=300,
                    attention_multiplier=0.25)


def _json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_tiny_root(root: Path) -> Path:
    """``root`` with ``perfbench/`` copied and a ``BENCHMARK.json`` of the
    tiny cells ``tiny-fl`` (paper-cnn cut to 8 UAVs, K=4, 2 seeds x b 1..3,
    4 rounds) and ``tiny-prefill`` (granite cut to 2 layers of width 64,
    4 experts, top-2, 256-token batches); both on the CPU."""
    root = Path(root)
    pb = root / "perfbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py"))
    cnn = json.loads((HERE / "configs" / "paper-cnn.json").read_text())
    cnn["name"] = "tiny-cnn"
    cnn["hsfl"].update(TINY_CNN)
    _json(pb / "configs" / "tiny-cnn.json", cnn)
    fl = json.loads((HERE / "traffic" / "fl-fig3c-8seeds.json").read_text())
    fl.update(seeds_per_panel=2, rounds=4, b=[1.0, 2.0, 3.0], check_rows=3)
    # the test size's own limits: over its 4 rounds no trajectory forks,
    # so its sound runs read a loss gap under 2e-7 and a late accuracy gap
    # under 1e-8; the TF32 control 5.2e-4 to 5.5e-3 and 0.005 to 0.02, a
    # round's aggregate not carried 0.022 to 0.05 on the accuracy
    fl["limits"]["tiny-cnn"] = {**fl["limits"]["paper-cnn"],
                                "loss_rel": 1e-4, "late_acc_gap": 0.01}
    _json(pb / "traffic" / "fl-tiny.json", fl)
    gr = json.loads((HERE / "configs" / "granite-moe-3b-a800m.json")
                    .read_text())
    gr.update(name="tiny-granite", **TINY_GRANITE)
    _json(pb / "configs" / "tiny-granite.json", gr)
    pf = json.loads((HERE / "traffic" / "prefill-chat.json").read_text())
    pf.update(tokens_per_batch=256, cycle=8,
              seq={"median": 48, "sigma": 0.6, "min": 16, "max": 64,
                   "multiple": 16})
    # the test size's own limits: its sound runs read a median gap of
    # 0.011-0.02 and its control 0.14; with 4 experts and top-2 a bf16
    # route flip moves a whole position (widest gaps up to 1.13)
    pf["limits"]["tiny-granite"] = {"logits_rel_median": 0.06,
                                    "logits_rel_max": 2.0}
    _json(pb / "traffic" / "prefill-tiny.json", pf)
    for new, old in (("tiny-cnn", "paper-cnn"),
                     ("tiny-granite", "granite-moe-3b-a800m")):
        for sub in ("work", "reference"):
            shutil.copy(pb / sub / f"{old}.py", pb / sub / f"{new}.py")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": "tiny-cnn", "source": "https://arxiv.org/abs/2306.09484",
         "file": "perfbench/configs/tiny-cnn.json", "reduced": [],
         "why": "test size"},
        {"name": "tiny-granite", "source": "test",
         "file": "perfbench/configs/tiny-granite.json", "reduced": [],
         "why": "test size"}]
    rename = {"cnn-fig3c-8seeds": "tiny-fl",
              "granite-prefill-chat": "tiny-prefill"}
    bench["workloads"] = [
        {"name": "tiny-fl", "config": "tiny-cnn", "traffic": "fl-tiny",
         "chips": 1, "why": "test size"},
        {"name": "tiny-prefill", "config": "tiny-granite",
         "traffic": "prefill-tiny", "chips": 1, "why": "test size"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    _json(root / "BENCHMARK.json", bench)
    return root
