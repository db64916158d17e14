"""The harness finds every configuration, cell and metric by name, and
BENCHMARK.json keeps to the shape its readers assume."""

import json
import re

import pytest

from perfbench.tests import tiny  # noqa: F401  (sets up the import paths)
from perfbench.harness import bench

BENCH = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_are_found_by_name(cell):
    c = bench.load_cell(cell)
    assert c.traffic["loop"] in ("open", "closed", "train")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    cfg = bench.model_config(c.model)
    assert cfg.num_layers == c.model["num_layers"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:  # each per-layer metric's end-to-end metric is reported here too
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(bench.reader(metric))
    assert NAME.match(metric)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(entry["name"])
        assert 1 <= len(entry["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_what_runs(conf):
    with open(bench.ROOT / conf["file"]) as f:
        data = json.load(f)
    assert conf["file"].startswith("perfbench/")
    port = data["port"]
    assert port["dtype"] == "bfloat16"
    for key in conf["reduced"]:
        assert key in data["published"]
