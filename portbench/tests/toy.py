"""Toy sizes of each cell for the CPU tests: the same drivers, plans and
checks at n = 16, d = 8."""
from __future__ import annotations

from portbench import registry


#: cells whose generator the harness keeps but ``BENCHMARK.json`` does not
#: run yet: name -> (config, traffic)
KEPT = {"scf-fused": ("scf-256-2k", "scf-steady"),
        "paper-service": ("fftb-paper-256", "service-overload")}


def toy(cell_name: str):
    """(bench, config, traffic) of ``cell_name`` cut to toy size; a kept
    cell is added to the returned copy of the benchmark."""
    bench = registry.load_benchmark()
    if cell_name in KEPT:
        config, traffic = KEPT[cell_name]
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({
                "name": config, "source": "", "reduced": [], "why": "",
                "file": f"portbench/configs/{config}.json"})
        bench["workloads"].append({
            "name": cell_name, "config": config, "traffic": traffic,
            "chips": 1, "why": ""})
    cell = registry.cell(bench, cell_name)
    cfg = dict(registry.load_config(bench, cell["config"]), n=16,
               diameter=8)
    mix = dict(registry.load_traffic(cell["traffic"]))
    if "nb" in cfg:
        cfg.update(nb=8, band_batch=4)
    if "nbands" in cfg:
        cfg.update(nbands=4)
    if mix["driver"] == "service":
        mix.update(rate_per_s=20.0, check_requests=8, drain_s=20.0)
    return bench, cfg, mix
