"""Every cell of BENCHMARK.json resolves to its files by name, and the file
keeps to the contract's shape."""
import json
import os
import re

import pytest

from port_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(NAME.match(n) for n in names)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in metrics)
    texts = [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    found = harness.resolve(cell, BENCH)
    config, traffic = found["config"], found["traffic"]
    harness.load_module("configs", config["name"])
    harness.load_module("reference", config["name"])
    driver = harness.load_module("drivers", traffic["driver"])
    limits = harness.load_json(harness.BENCH_DIR, "limits", f"{cell}.json")["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    for metric in found["end_to_end"] + found["per_layer"]:
        assert callable(harness.load_module("metrics", metric["name"]).read)
    # a cell reports set-up, one more end-to-end metric and one per-layer one
    assert "setup_s" in {m["name"] for m in found["end_to_end"]}
    assert len(found["end_to_end"]) >= 2 and found["per_layer"]
    # the per-layer metrics of a cell move an end-to-end metric it reports
    reported = {m["name"] for m in found["end_to_end"]}
    assert all(m["moves"] in reported for m in found["per_layer"])
    assert all(callable(getattr(driver, f)) for f in ("setup", "prepare", "warm_up", "window",
                                                      "traced", "check"))


def test_configs_are_their_files():
    for entry in BENCH["configs"]:
        config = harness.load_json(harness.ROOT, entry["file"])
        assert config["name"] == entry["name"]
        assert config["reduced"] == entry["reduced"] == []
        assert os.path.isdir(os.path.join(harness.ROOT, config["data_dir"]))
