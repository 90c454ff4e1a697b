"""BENCHMARK.json against the files that make each cell: one cell file a
workload, its configuration and mix, one reader a per-layer metric with
the manifest's unit and source, and each cell's metrics those the
manifest names for it."""
import json
import os
import re

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_files():
    m = _manifest()
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        cfg = harness.load("configs", c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        cell = harness.load("cells", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                   w["chips"])
        harness.load("traffic", w["traffic"])
    for p in m["per_layer"]:
        assert NAME.match(p["name"])
        reader = harness.load_module("metrics", p["name"])
        assert (reader.UNIT, reader.SOURCE) == (p["unit"], p["source"])


def test_each_cell_reports_its_metrics():
    m = _manifest()
    for w in m["workloads"]:
        cell = harness.load("cells", w["name"])
        e2e = [e["name"] for e in m["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        per = [p["name"] for p in m["per_layer"] if w["name"] in p["workloads"]]
        assert sorted(cell["end_to_end"]) == sorted(e2e) and "setup_s" in e2e and len(e2e) >= 2
        assert sorted(cell["per_layer"]) == sorted(per) and per
        for p in m["per_layer"]:
            if w["name"] in p["workloads"]:
                assert p["moves"] in e2e


def test_roofline_and_mfu_names():
    m = _manifest()
    for p in m["per_layer"]:
        if "roofline" in p["name"]:
            assert p["name"].split(".")[0].endswith("_roofline") and p["unit"] == "%"
    assert {p["moves"] for p in m["per_layer"] if "mfu" in p["name"]} == {
        "eval_rows_per_s", "train_step_ms"}
