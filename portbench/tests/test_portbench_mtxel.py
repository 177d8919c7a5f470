"""The GW matrix-element cell ``gw-mtxel``: found by name, its work counted
by hand, its limit between the program and the TF32 control, two planted
faults caught, and no JAX or JAX package loaded, at a toy size of its own
on the CPU (n = 16, d = 8, d_eps = 4, 8 conduction bands in calls of 4,
3 valence bands)."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.limits import readings
from portbench.reference import Sphere, gap
from portbench.reference_mtxel import MatrixElements, cutoff_sphere
from portbench.roofline import bound_s
from portbench.run import run_cell

CELL = "gw-mtxel"
BENCH = registry.load_benchmark()
APPENDED = ("pair_ms", "pair_roofline", "dft_matmul_roofline",
            "sphere_pack_roofline", "device_idle_pct.pair",
            "relayout_ms.pair", "relayout_gb.pair")
NEW = ("product_ms.mtxel", "product_gb.mtxel")


def _toy():
    cell = registry.cell(BENCH, CELL)
    cfg = dict(registry.load_config(BENCH, cell["config"]), n=16,
               diameter=8, diameter_eps=4, nb=8, band_batch=4, nv=3)
    return cfg, dict(registry.load_traffic(cell["traffic"]))


def _run(seed: int = 11, seconds: float = 0.5, trace: bool = False):
    cfg, mix = _toy()
    line, _ = run_cell(BENCH, CELL, seed, seconds, trace, "cpu",
                       config=cfg, traffic=mix)
    return line


def test_cell_config_mix_and_metrics_resolve_by_name():
    w = registry.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "gw-mtxel-256", "mtxel-closed", 1)
    cfg = registry.load_config(BENCH, w["config"])
    assert cfg["name"] == "gw-mtxel-256"
    assert registry.config_entry(BENCH, w["config"])["reduced"] == []
    assert (cfg["n"], cfg["diameter"], cfg["diameter_eps"], cfg["nb"],
            cfg["band_batch"], cfg["nv"]) == (256, 128, 64, 256, 128, 8)
    mix = registry.load_traffic(w["traffic"])
    drv = registry.driver(mix)
    assert drv.__name__ == "portbench.drivers.mtxel"
    assert set(mix["limits"]) == {"mtxel_gap"}
    assert [m["name"] for m in registry.end_to_end(BENCH, CELL)] == [
        "pair_ms", "setup_s"]
    layer = {m["name"]: m for m in registry.per_layer(BENCH, CELL)}
    assert set(layer) == set(APPENDED[1:]) | set(NEW)
    for name in NEW:
        assert layer[name]["layer"] == ("dft: the pair-density product "
                                        "between the legs")
        assert layer[name]["moves"] == "pair_ms"
        assert callable(registry.reader(name))


def test_spheres_match_the_port():
    """The wave functions' sphere as the paper pair's; the cut-off sphere
    about G = 0, the reference's own against the port's."""
    from repro_torch.core.planewave import kpoint_sphere
    from repro_torch.dft import cutoff_sphere as port_cutoff
    for s, p, npk, ncols in (
            (Sphere(128), kpoint_sphere(128), 1_099_136, 12_892),
            (cutoff_sphere(64), port_cutoff(64), 137_062, 3_207)):
        assert np.array_equal(s.lanes, p.pack_indices())
        assert tuple(s.center) == tuple(p.center)
        assert (s.npacked, s.ncols) == (npk, ncols)
    g = cutoff_sphere(64).gvectors()
    assert (g == 0).all(1).sum() == 1 and (g.min(), g.max()) == (-32, 31)


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_reference_g0_lane_is_the_overlap(precision):
    """The reference's G = 0 lane is sum_r conj(ψ_v) ψ_c = <v|c> / n³."""
    n, d, d_eps = 16, 8, 4
    g = torch.Generator().manual_seed(3)
    npk = Sphere(d).npacked
    c_c = torch.randn((5, npk), dtype=torch.complex128, generator=g)
    c_v = torch.randn((1, npk), dtype=torch.complex128, generator=g)
    ref = MatrixElements(n, d, d_eps, "cpu", precision)
    got = ref(c_c, ref.valence(c_v[0]))
    g0 = int(np.flatnonzero((cutoff_sphere(d_eps).gvectors() == 0).all(1))[0])
    want = (c_v[0].conj() * c_c).sum(1) / n ** 3
    tol = 1e-12 if precision == "float64" else 1e-2
    assert gap(got[:, g0], want) <= tol


def test_full_size_work_and_bound():
    from portbench.drivers.mtxel import mtxel_calls, mtxel_work
    nbytes, flops = mtxel_work(256, 1_099_136, 137_062, 256)
    # 256 (1,099,136 + 256^3) + 256^3 + 256 (256^3 + 137,062) complex64
    assert nbytes == 8 * (256 * (1_099_136 + 256 ** 3) + 256 ** 3
                          + 256 * (256 ** 3 + 137_062))
    assert round(nbytes / 1e9, 2) == 71.39
    assert round(flops / 1e12, 3) == 1.031
    assert round(bound_s(nbytes, flops) * 1e3, 2) == 21.31
    calls = mtxel_calls(256, 128, 64, 128)
    assert [len(calls[k]) for k in ("dft_matmul", "sphere_pack",
                                    "sphere_pack_tail")] == [4, 2, 1]
    # the forward's first stage: every line of the cube, 256 -> 64
    assert calls["dft_matmul"][2][0] == 8 * 128 * 256 ** 2 * (256 + 64)
    # dft_pack reads the cut-off sphere's 3,207 columns of 256 a row
    assert calls["sphere_pack"][1][0] == 8 * 128 * (3_207 * 256 + 137_062)


def test_program_passes_and_control_fails():
    cfg, mix = _toy()
    out = readings(BENCH, CELL, [21, 2 ** 31 + 22], [121], 0.3, "cpu",
                   config=cfg, traffic=mix)
    limit = mix["limits"]["mtxel_gap"]
    for seed, nums in out["program"].items():
        assert nums["mtxel_gap"] <= limit, (seed, nums)
    for seed, nums in out["control"].items():
        assert nums["mtxel_gap"] > limit, (seed, nums)


def test_sound_run_is_correct_and_traced_readers_read():
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    got = line["metrics"]["product_gb.mtxel"]
    # a call multiplies 4 cubes of 16^3 in place (read and written) and
    # reads the valence cube once; two calls a pair
    assert got["unit"] == "GB"
    assert got["value"] == pytest.approx(2 * (2 * 4 + 1) * 16 ** 3 * 8 / 1e9,
                                         rel=1e-12)
    assert "product_ms.mtxel" not in line["metrics"]     # no device time
    facts = {"trace": None, "pairs": line["attempted"]}
    for name in NEW:
        assert registry.reader(name)(facts) is None


def test_unconjugated_valence_is_caught(monkeypatch):
    import repro_torch.dft as dft
    orig = dft.valence_conjugates
    # ψ_v · e^{2πi s·r/n}: the centring phase kept, the conjugate left out
    monkeypatch.setattr(dft, "valence_conjugates",
                        lambda inv, fwd, c_v: orig(inv, fwd, c_v).conj()
                        * dft.centring_phase(inv, fwd) ** 2)
    line = _run()
    assert not line["correct"], line["checks"]


def test_half_the_conduction_bands_skipped_is_caught(monkeypatch):
    import repro_torch.dft as dft
    orig = dft.pair_density
    calls = {"n": 0}

    def skip_every_other(inv, fwd, c_c, vconj):
        calls["n"] += 1
        if calls["n"] % 2 == 0:           # the pair's second call skipped
            return torch.zeros((c_c.shape[0], fwd.sphere.npacked),
                               dtype=torch.complex64)
        return orig(inv, fwd, c_c, vconj)
    monkeypatch.setattr(dft, "pair_density", skip_every_other)
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
    assert _imports(registry.HERE / "reference_mtxel.py") <= {
        "__future__", "contextlib", "math", "torch"}
    code = """
import sys
sys.path[:0] = ['src', '.']
import portbench.reference_mtxel
assert not {m.split('.')[0] for m in sys.modules} & {
    'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}
from portbench import registry
from portbench.run import forbidden_modules, run_cell
bench = registry.load_benchmark()
cell = registry.cell(bench, 'gw-mtxel')
cfg = dict(registry.load_config(bench, cell['config']), n=16, diameter=8,
           diameter_eps=4, nb=8, band_batch=4, nv=3)
line, _ = run_cell(bench, 'gw-mtxel', 5, 0.2, False, 'cpu', config=cfg)
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
