"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell, configuration, mix and metric by name."""
from __future__ import annotations

import json
import re

import pytest

from portbench import registry
from portbench.roofline import bound_s, pair_work

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert registry.BENCHMARK.stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (registry.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line_ok(w) for w in cmd)
    for word in cmd[1:]:
        assert any(word == p or word.startswith(p + "/")
                   for p in BENCH["paths"])


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_the_contract_keys(section, keys):
    for e in BENCH[section]:
        assert set(e) == keys, e["name"]
        assert NAME.match(e["name"])
        assert _line_ok(e["why"])


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert _line_ok(m["layer"])
        for cell in m.get("workloads", []):
            # every cell a metric lists reports the metric it moves
            assert cell in CELLS
            assert any(x["name"] == m["moves"]
                       for x in registry.end_to_end(BENCH, cell))
        if m["unit"] == "%" and m["name"].endswith("roofline"):
            assert m["better"] == "higher"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w = registry.cell(BENCH, cell)
    assert w["chips"] == 1
    cfg = registry.load_config(BENCH, w["config"])
    entry = registry.config_entry(BENCH, w["config"])
    assert entry["file"].startswith("portbench/configs/")
    assert all(NAME.match(k) for k in entry["reduced"])
    assert cfg["name"] == w["config"]
    mix = registry.load_traffic(w["traffic"])
    drv = registry.driver(mix)
    assert callable(drv.run) and callable(drv.control)
    assert set(mix["limits"]) and all(v > 0 for v in mix["limits"].values())
    e2e = [m["name"] for m in registry.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.per_layer(BENCH, cell)
    assert layer
    for m in layer:
        assert callable(registry.reader(m["name"]))


def test_each_config_is_used_and_has_its_own_file():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_reader_file_is_a_metric():
    named = {m["name"] for m in BENCH["per_layer"]}
    files = {p.stem for p in (registry.HERE / "metrics").glob("*.py")}
    assert files == named


def test_reader_finds_nothing_without_a_trace():
    for m in BENCH["per_layer"]:
        assert registry.reader(m["name"])({"trace": None}) is None


def test_pair_bytes_and_bound():
    nbytes, flops = pair_work(256, 1_099_136, 256)
    assert round(nbytes / 1e9, 2) == 73.22
    assert round(flops / 1e12, 3) == 1.031
    assert round(bound_s(nbytes, flops) * 1e3, 2) == 21.86


def test_benchmark_json_is_plain_json():
    text = registry.BENCHMARK.read_text()
    assert json.loads(text) == BENCH
