"""The plain reference: its own sphere lanes and transforms against the
port's and numpy's, the TF32 control's rounding, the SCF followed from the
same start as the port's, and what the harness and reference import."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.reference import SCF, Sphere, Transforms, gap, tf32_round


@pytest.mark.parametrize("d,kpt", [(8, (0, 0, 0)), (12, (0.25, -0.25, 0.25)),
                                   (16, (0.5, 0.5, 0.5)), (128, (0, 0, 0))])
def test_sphere_lanes_match_the_port(d, kpt):
    from repro_torch.core.planewave import kpoint_sphere
    s, p = Sphere(d, kpt), kpoint_sphere(d, kpt)
    assert np.array_equal(s.lanes, p.pack_indices())
    assert s.ncols == p.ncols
    if d == 128 and kpt == (0, 0, 0):
        assert s.npacked == 1_099_136


def test_transforms_against_numpy():
    n, d = 12, 6
    s = Sphere(d, (0.25, 0.0, -0.25))
    rng = np.random.default_rng(0)
    c = (rng.standard_normal((3, s.npacked))
         + 1j * rng.standard_normal((3, s.npacked)))
    box = np.zeros((3, d ** 3), complex)
    box[:, s.lanes] = c
    cube = np.zeros((3, n, n, n), complex)
    cube[:, :d, :d, :d] = box.reshape(3, d, d, d)
    want = np.fft.ifftn(cube, axes=(1, 2, 3))
    tf = Transforms(n, d, "cpu")
    got = tf.inverse(torch.as_tensor(c), s)
    assert gap(got, torch.as_tensor(want)) < 1e-13
    v = rng.standard_normal((n, n, n))
    spec = np.fft.fftn(want * v, axes=(1, 2, 3))[:, :d, :d, :d]
    want_rt = spec.reshape(3, -1)[:, s.lanes]
    got_rt = tf.round_trip(torch.as_tensor(c), s, torch.as_tensor(v))
    assert gap(got_rt, torch.as_tensor(want_rt)) < 1e-13
    assert gap(tf.round_trip(torch.as_tensor(c), s), torch.as_tensor(c)) \
        < 1e-13


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -12,
                      1.0 + 3 * 2 ** -12], dtype=torch.float32)
    got = tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0,
                         1.0 + 2 ** -10], dtype=torch.float32)
    assert torch.equal(got, want)
    y = torch.randn(1000)
    assert float(((tf32_round(y) - y).abs() / y.abs()).max()) <= 2 ** -11


def test_control_transform_is_tf32_accurate():
    n, d = 16, 8
    s = Sphere(d)
    c = torch.randn((2, s.npacked), dtype=torch.complex64)
    ref = Transforms(n, d, "cpu").inverse(c, s)
    low = Transforms(n, d, "cpu", "tf32").inverse(c, s)
    assert 1e-5 < gap(low, ref) < 3e-3


def test_reference_scf_follows_the_port():
    """The reference's first iterations from the port's own start agree
    with the port's fused step (toy size, CPU): energies to float32."""
    from repro_torch.dft import run_scf
    from portbench.drivers.scf import make_start, scf_config
    from portbench.run import Context
    from portbench.tests.toy import toy
    bench, cfg, mix = toy("scf-fused")
    cell = registry.cell(bench, "scf-fused")
    ctx = Context(cell, cfg, mix, 7, 1.0, "cpu", False)
    v, bands = make_start(ctx, cfg, mix, 0)
    energies = []
    run_scf(dict_to(scf_config(cfg), max_iter=4), device="cpu",
            v_ext=v.clone(), coeffs=[b.clone() for b in bands],
            callback=lambda it, e, r: energies.append(e))
    ref = SCF(cfg, v, bands, "cpu")
    for e in energies:
        assert abs(e - ref.iterate()[0]) <= 1e-5 * abs(e)


def dict_to(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    mods = _imports(registry.HERE / "reference.py")
    assert mods <= {"__future__", "math", "numpy", "torch"}
    code = ("import sys; sys.path.insert(0, '.'); "
            "import portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_harness_loads_no_jax():
    """Every module a run loads (the harness, each driver, each reader,
    the program) has no top-level name of JAX or the JAX package; the
    port's own name, which starts with the JAX package's, is allowed."""
    code = """
import sys
sys.path[:0] = ['src', '.']
import portbench.run as r
from portbench import registry
bench = registry.load_benchmark()
for w in bench['workloads']:
    registry.driver(registry.load_traffic(w['traffic']))
for m in bench['per_layer']:
    registry.reader(m['name'])
import portbench.limits
import repro_torch.dft, repro_torch.serve, repro_torch.core
top = {m.split('.')[0] for m in sys.modules}
assert 'repro_torch' in top
print(r.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_names_compare_the_top_level_whole(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in run.forbidden_modules()


def test_harness_reads_nothing_of_the_old_benchmarks():
    for p in registry.HERE.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "chip_smoke" not in text, p
