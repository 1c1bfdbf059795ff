"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries of BENCHMARK.json, with no edit to any file that is
there: the harness finds them by name."""
import hashlib
import json
import shutil

from perfbench import harness, testing


def _digests(pb):
    return {str(p.relative_to(pb)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pb.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_files_alone(tmp_path):
    root = testing.make_tiny_root(tmp_path)
    pb = root / "perfbench"
    before = _digests(pb)

    cfg = json.loads((pb / "configs" / "tiny-cnn.json").read_text())
    cfg.update(name="extra-cnn")
    cfg["hsfl"]["n_uavs"] = 6
    (pb / "configs" / "extra-cnn.json").write_text(json.dumps(cfg))
    for sub in ("work", "reference"):
        shutil.copy(pb / sub / "tiny-cnn.py", pb / sub / "extra-cnn.py")
    mix = json.loads((pb / "traffic" / "fl-tiny.json").read_text())
    mix.update(rounds=1, b=[2.0], check_rows=1)
    mix["limits"] = {"extra-cnn": mix["limits"]["tiny-cnn"]}
    (pb / "traffic" / "fl-extra.json").write_text(json.dumps(mix))
    (pb / "metrics" / "group_rounds.extra.py").write_text(
        "def read(run):\n    return run.counters.get('group_rounds')\n")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra-cnn", "source": "test",
                             "file": "perfbench/configs/extra-cnn.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "extra", "config": "extra-cnn",
                               "traffic": "fl-extra", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fl_row_rounds_per_s":
            m["workloads"].append("extra")
    bench["per_layer"].append({"name": "group_rounds.extra",
                               "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "fl_row_rounds_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/extra-cnn.json", "work/extra-cnn.py",
        "reference/extra-cnn.py", "traffic/fl-extra.json",
        "metrics/group_rounds.extra.py"}

    found = harness.Benchmark(root)
    assert found.config("extra-cnn")["hsfl"]["n_uavs"] == 6
    # a metric without ``workloads`` is read in every cell that reports
    # the end-to-end metric it moves
    assert [m["name"] for m in found.per_layer("extra")] == [
        "group_rounds.extra"]
    assert "group_rounds.extra" in [m["name"]
                                    for m in found.per_layer("tiny-fl")]
    out = harness.run_cell("extra", 5, 0.0, True, "cpu", root)
    assert out["correct"], out["checks"]
    assert out["metrics"]["group_rounds.extra"] == {"value": 1,
                                                    "unit": "rounds"}
    plain = harness.run_cell("extra", 5, 0.0, False, "cpu", root)
    assert set(plain["metrics"]) == {"setup_s", "fl_row_rounds_per_s"}
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
