"""BENCHMARK.json keeps to the benchmark's format, and every name in it
leads to its files under perfbench/."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # a full check of 24 cells fits its 43 200 s
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    data = json.loads((harness.ROOT / c["file"]).read_text())
    assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for sub in ("work", "reference"):
        assert (harness.HERE / sub / f"{c['name']}.py").is_file()


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    traffic = json.loads((harness.HERE / "traffic"
                          / f"{w['traffic']}.json").read_text())
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert set(traffic["limits"][w["config"]])
    bench = harness.Benchmark()
    e2e = {m["name"] for m in bench.end_to_end(w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.per_layer(w["name"])


def test_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) <= 64 * 1024
