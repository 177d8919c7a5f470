"""Finds everything by name: a cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (whose ``driver`` names the generator under
``drivers/``) and each per-layer metric's reader in
``metrics/<metric>.py``.  A new cell, configuration, mix or metric is a
new file and a new entry; no file here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path=BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    entry = config_entry(bench, name)
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def driver(traffic: dict):
    """The generator module a traffic mix names."""
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str):
    """The ``read(facts)`` function of a per-layer metric."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell_name: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell_name in ws


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The cell's end-to-end metrics."""
    return [m for m in bench["end_to_end"] if _reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those that
    list no cells but move an end-to-end metric the cell reports."""
    mine = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        ws = m.get("workloads")
        if (cell_name in ws) if ws is not None else m["moves"] in mine:
            out.append(m)
    return out
