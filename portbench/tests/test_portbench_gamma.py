"""The Γ-point cell ``gamma-pair``: found by name, its work counted by hand,
its limits between the program and the TF32 control, three planted faults
caught, and no JAX or JAX package loaded, at a toy size of its own on the
CPU (n = 16, d = 8, 8 real bands in calls of 4)."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.limits import readings
from portbench.reference import gap
from portbench.reference_gamma import GammaSphere, GammaTransforms
from portbench.roofline import bound_s, pair_calls
from portbench.run import run_cell

CELL = "gamma-pair"
BENCH = registry.load_benchmark()
APPENDED = ("pair_ms", "pair_roofline", "dft_matmul_roofline",
            "sphere_pack_roofline", "device_idle_pct.pair",
            "relayout_ms.pair", "relayout_gb.pair")
NEW = ("fold_ms.gamma", "fold_gb.gamma", "fold_roofline.gamma")


def _toy():
    cell = registry.cell(BENCH, CELL)
    cfg = dict(registry.load_config(BENCH, cell["config"]), n=16,
               diameter=8, nb=8, band_batch=4)
    return cfg, dict(registry.load_traffic(cell["traffic"]))


def _run(seed: int = 11, seconds: float = 0.5, trace: bool = False):
    cfg, mix = _toy()
    line, _ = run_cell(BENCH, CELL, seed, seconds, trace, "cpu",
                       config=cfg, traffic=mix)
    return line


def test_cell_config_mix_and_metrics_resolve_by_name():
    w = registry.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "fftb-gamma-256", "gamma-closed", 1)
    cfg = registry.load_config(BENCH, w["config"])
    assert cfg["name"] == "fftb-gamma-256"
    assert registry.config_entry(BENCH, w["config"])["reduced"] == []
    assert (cfg["n"], cfg["diameter"], cfg["nb"], cfg["band_batch"],
            cfg["dtype"], cfg["backend"], cfg["grid"]) == (
        256, 128, 256, 256, "complex64", "cuda", [1])
    mix = registry.load_traffic(w["traffic"])
    assert registry.driver(mix).__name__ == "portbench.drivers.gamma"
    assert set(mix["limits"]) == {"cube_gap", "round_trip_gap"}
    assert [m["name"] for m in registry.end_to_end(BENCH, CELL)] == [
        "pair_ms", "setup_s"]
    layer = {m["name"]: m for m in registry.per_layer(BENCH, CELL)}
    assert set(layer) == set(APPENDED[1:]) | set(NEW)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] in APPENDED:
            assert m["workloads"] == ["paper-pair", "gw-mtxel", CELL]
    for name in NEW:
        assert layer[name]["layer"] == ("gamma: the fold and unfold of real "
                                        "band pairs")
        assert layer[name]["moves"] == "pair_ms"
        assert callable(registry.reader(name))


def test_sphere_matches_the_port():
    """The reference's Γ sphere and half against the port's, at the
    cell's size, and the configuration's counts."""
    from repro_torch.core import gamma_sphere, half_lanes
    cfg = registry.load_config(BENCH, "fftb-gamma-256")
    s, p = GammaSphere(128), gamma_sphere(128)
    lane, mirror = half_lanes(p)
    assert np.array_equal(s.lanes, p.pack_indices())
    assert np.array_equal(s.half, lane) and np.array_equal(s.mirror, mirror)
    assert (s.npacked, s.ncols, s.nhalf) == (
        cfg["npacked"], cfg["ncols"], cfg["nhalf"]) == (
        1_097_911, 12_849, 548_956)


def test_full_size_work_and_bound():
    from portbench.drivers.gamma import fold_work, gamma_work
    nbytes, flops = gamma_work(256, 548_956, 256)
    # per direction 256 × (548,956 complex64 in + 256^3 float32 of cube)
    assert nbytes == 2 * 256 * (548_956 * 8 + 256 ** 3 * 4)
    assert round(nbytes / 1e9, 2) == 36.61
    # 2.5 N log2 N a real 3D FFT, 256 bands, two directions
    assert flops == 2 * 256 * 2.5 * 256 ** 3 * 24
    assert round(bound_s(nbytes, flops) * 1e3, 2) == 10.93
    fold = fold_work(548_956, 1_097_911, 256)
    assert fold == 2 * 8 * (256 * 548_956 + 128 * 1_097_911)
    assert round(fold / 1e9, 2) == 4.50
    assert round(fold / 3.35e12 * 1e3, 2) == 1.34
    calls = pair_calls(256, 128, 1_097_911, 12_849, 128)
    assert [len(calls[k]) for k in ("dft_matmul", "sphere_pack")] == [4, 2]
    # dft_pack reads the Γ sphere's 12,849 columns of 256 a row
    assert calls["sphere_pack"][1][0] == 8 * 128 * (12_849 * 256
                                                    + 1_097_911)


def test_reference_separates_two_real_bands():
    """The control's fold into one complex band and back is the float64
    reference's two real bands, to TF32's rounding."""
    g = torch.Generator().manual_seed(3)
    c = torch.randn((4, GammaSphere(8).nhalf), dtype=torch.complex64,
                    generator=g)
    c[:, 0] = c[:, 0].real.to(c.dtype)
    hi = GammaTransforms(16, 8, "cpu", "float64")
    lo = GammaTransforms(16, 8, "cpu", "tf32")
    psi = hi.inverse(c)
    assert psi.shape == (4, 16, 16, 16) and psi.dtype == torch.float64
    assert gap(lo.inverse(c), psi) < 1e-2
    assert gap(hi.forward(psi), c) <= 1e-12


def test_program_passes_and_control_fails():
    cfg, mix = _toy()
    out = readings(BENCH, CELL, [21, 2 ** 31 + 22], [121], 0.3, "cpu",
                   config=cfg, traffic=mix)
    limits = mix["limits"]
    for seed, nums in out["program"].items():
        assert all(nums[k] <= limits[k] for k in limits), (seed, nums)
    for seed, nums in out["control"].items():
        assert all(nums[k] > limits[k] for k in limits), (seed, nums)


def test_sound_run_is_correct_and_traced_readers_read():
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    got = line["metrics"]["fold_gb.gamma"]
    # a call folds 4 real bands of 126 lanes into 2 rows of 251, and back;
    # two calls a pair
    assert got["unit"] == "GB"
    assert got["value"] == pytest.approx(
        2 * 2 * (4 * 126 + 2 * 251) * 8 / 1e9, rel=1e-12)
    assert "fold_ms.gamma" not in line["metrics"]        # no device time
    assert "fold_roofline.gamma" not in line["metrics"]
    facts = {"trace": None, "pairs": line["attempted"]}
    for name in NEW:
        assert registry.reader(name)(facts) is None


def test_unconjugated_mirror_is_caught(monkeypatch):
    import repro_torch.kernels.gamma as gk

    real = gk.gamma_fold_plain

    def unconjugated(half, lane, mirror, npacked):
        out = real(half, lane, mirror, npacked)
        out[:, mirror.long()] = half[0::2] + 1j * half[1::2]
        out[:, lane.long()] = half[0::2] + 1j * half[1::2]
        return out
    monkeypatch.setattr(gk, "gamma_fold_plain", unconjugated)
    line = _run()
    assert not line["correct"], line["checks"]
    assert line["checks"]["cube_gap"]["value"] > 100 * line["checks"][
        "cube_gap"]["limit"]


def test_unfold_without_the_mirror_term_is_caught(monkeypatch):
    import repro_torch.kernels.gamma as gk

    def no_mirror_term(full, lane, mirror, nb):
        f = full[:, lane.long()]          # F(G) alone, no conj F(−G)
        return torch.stack((f, f * -1j), 1).reshape(-1, f.shape[1])[:nb]
    monkeypatch.setattr(gk, "gamma_unfold_plain", no_mirror_term)
    line = _run()
    assert not line["correct"], line["checks"]
    assert line["checks"]["round_trip_gap"]["value"] > 100 * line["checks"][
        "round_trip_gap"]["limit"]


def test_half_the_bands_skipped_is_caught(monkeypatch):
    from repro_torch.core.gamma import GammaPlaneWave
    orig = GammaPlaneWave.transform_pack
    calls = {"n": 0}

    def skip_every_other(self, cube, **kw):
        calls["n"] += 1
        out = orig(self, cube, **kw)
        if calls["n"] % 2 == 0:           # the pair's second call skipped
            return torch.zeros_like(out)
        return out
    monkeypatch.setattr(GammaPlaneWave, "transform_pack", skip_every_other)
    line = _run()
    assert calls["n"] > 2
    assert not line["correct"], line["checks"]


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_reference_and_driver_load_no_jax_and_no_repro():
    assert _imports(registry.HERE / "reference_gamma.py") <= {
        "__future__", "contextlib", "math", "numpy", "torch"}
    code = """
import sys
sys.path[:0] = ['src', '.']
import portbench.reference_gamma
assert not {m.split('.')[0] for m in sys.modules} & {
    'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}
from portbench import registry
from portbench.run import forbidden_modules, run_cell
bench = registry.load_benchmark()
cell = registry.cell(bench, 'gamma-pair')
cfg = dict(registry.load_config(bench, cell['config']), n=16, diameter=8,
           nb=8, band_batch=4)
line, _ = run_cell(bench, 'gamma-pair', 5, 0.2, False, 'cpu', config=cfg)
assert line['correct'], line
assert 'repro_torch' in {m.split('.')[0] for m in sys.modules}
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_have_reader_files(name):
    assert (registry.HERE / "metrics" / f"{name}.py").is_file()


def test_roofline_reader_reads_the_spans_against_the_problem(monkeypatch):
    """fold_roofline.gamma from fold_ms.gamma's spans and the driver's
    bytes: 4.5 GB in 1.5 ms a pair is 89.5% of 3.35 TB/s."""
    import types

    from repro_torch import obs
    spans = {"gamma:fold": {"count": 3, "device_ms": 2.25, "bytes": 0},
             "gamma:unfold": {"count": 3, "device_ms": 2.25, "bytes": 0}}
    fake = types.SimpleNamespace(dropped=0, device_summary=lambda: spans)
    monkeypatch.setattr(obs, "get_tracer", lambda: fake)
    facts = {"trace": object(), "pairs": 3, "fold_work": 4.5e9}
    assert registry.reader("fold_ms.gamma")(facts) == pytest.approx(1.5)
    assert registry.reader("fold_roofline.gamma")(facts) == pytest.approx(
        100 * 4.5e9 / 3.35e12 / 1.5e-3)
    spans["gamma:unfold"]["count"] = 2          # not the same every pair
    assert registry.reader("fold_roofline.gamma")(facts) is None
