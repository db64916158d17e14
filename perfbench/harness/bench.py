"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its output check
(``cells/<cell>.json``) and the reader of each metric
(``metrics/<metric>.py``, a function ``read(run)``).  Adding a cell, a mix
or a metric adds files and entries; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    model: dict  # the config file's "port" block: the ModelConfig the program runs
    config_file: dict
    traffic_name: str
    traffic: dict
    limits: dict  # check name -> limit
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench or benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config_file = _json(root / conf["file"])
    return Cell(
        name=name,
        chips=entry["chips"],
        config_name=conf["name"],
        model=config_file["port"],
        config_file=config_file,
        traffic_name=entry["traffic"],
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(HERE / "cells" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def model_config(m: dict):
    """The program's ``ModelConfig`` for a config file's ``port`` block."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    kw = {k: v for k, v in m.items() if k != "moe"}
    if m.get("moe") is not None:
        kw["moe"] = MoEConfig(**m["moe"])
    return ModelConfig(**kw)
