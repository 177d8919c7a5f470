"""repro_torch.sharding and repro_torch.configs against the reference.

* ``choose_dft_grid_shape`` is the reference's chooser: the same shape for
  every device count, band count, diameter and k-point count tried.
* ``choose_dft_grid()`` counts processes (one per card), so one process
  gets the ``(1,)`` grid whatever the box holds; shapes over several
  processes stay refused until multi-rank execution is ported.
* The paper's configuration has the reference's fields, and its path —
  grid from the chooser, basis preflight, the fused plane-wave pair on
  the "cuda" route (the kernels' plain versions on the CPU) — holds to
  the reference's "matmul" pair at a reduced width (n=32, d=16, 8 bands)
  within 1e-6 of the largest value.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro.sharding.grids as RG
from repro.configs.fftb_paper import CONFIG as REF_CONFIG
import repro_torch.core as T
import repro_torch.sharding.grids as TG
from repro_torch.check import preflight_basis
from repro_torch.configs.fftb_paper import CONFIG, PlaneWaveConfig
from repro_torch.kernels import sphere_pack
from repro_torch.sharding import (DFT_AXES_1D, choose_dft_grid,
                                  choose_dft_grid_shape)

RTOL = 1e-6          # relative to the largest output magnitude

CHOOSER_CASES = [dict(nbands=nb, diameter=d, nk=nk)
                 for nb, d, nk in itertools.product(
                     (1, 2, 4, 6, 16, 256), (8, 12, 16, 64, 128), (1, 2, 4))]


@pytest.mark.parametrize("ndevices", [1, 2, 4, 8, 16])
def test_chooser_equals_reference(ndevices):
    for kw in CHOOSER_CASES:
        for frac in (2, 4):
            assert choose_dft_grid_shape(
                ndevices, max_fft_fraction=frac, **kw) == \
                RG.choose_dft_grid_shape(ndevices, max_fft_fraction=frac,
                                         **kw), (ndevices, frac, kw)


def test_chooser_reaches_every_tier_and_refuses_zero():
    shapes = {choose_dft_grid_shape(nd, **kw) for nd in (1, 2, 4, 8, 16)
              for kw in CHOOSER_CASES}
    assert {len(s) for s in shapes} == {1, 2, 3}
    assert DFT_AXES_1D == RG.DFT_AXES_1D
    assert (TG.DFT_AXES_2D, TG.DFT_AXES_3D) == (RG.DFT_AXES_2D,
                                                 RG.DFT_AXES_3D)
    with pytest.raises(ValueError, match="ndevices"):
        choose_dft_grid_shape(0, nbands=4, diameter=8)


def test_choose_dft_grid_counts_processes_not_cards(monkeypatch):
    # an eight-card box with one process still gets the one-process grid
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    g = choose_dft_grid(nbands=CONFIG.nb, diameter=CONFIG.diameter,
                        device="cpu")
    assert g.shape == (1,) and g.axes == DFT_AXES_1D
    assert g.device == torch.device("cpu")
    # a process group of four chooses (4,), a grid of four processes,
    # which needs torch.distributed initialized over them
    monkeypatch.setattr(TG, "_process_count", lambda: 4)
    with pytest.raises(RuntimeError, match="initialize torch.distributed"):
        choose_dft_grid(nbands=CONFIG.nb, diameter=CONFIG.diameter,
                        device="cpu")
    assert choose_dft_grid(1, nbands=4, diameter=8,
                           device="cpu").shape == (1,)


def test_choose_dft_grid_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        choose_dft_grid(nbands=4, diameter=8)


def test_paper_config_has_the_reference_fields():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(REF_CONFIG)
    assert (CONFIG.n, CONFIG.diameter, CONFIG.nb, CONFIG.backend) == \
        (256, 128, 256, "matmul")
    assert isinstance(CONFIG, PlaneWaveConfig)
    with pytest.raises(dataclasses.FrozenInstanceError):
        CONFIG.nb = 16


@pytest.mark.parametrize("backend", ["cuda", "matmul"])
def test_paper_path_at_reduced_width_matches_reference(backend):
    """The paper's path at n=32, d=16, 8 bands: chooser → basis
    preflight → fused pair, against the reference's
    "matmul" pair on the same coefficients."""
    cfg = dataclasses.replace(CONFIG, n=32, diameter=16, nb=8)
    grid = choose_dft_grid(nbands=cfg.nb, diameter=cfg.diameter,
                           device="cpu")
    assert grid.shape == (1,) and grid.axes == DFT_AXES_1D
    assert preflight_basis(cfg.n, diameter=cfg.diameter, nbands=cfg.nb,
                           grid=grid, backend=backend, deep=True) == []
    sph = T.SphereDomain.from_diameter(cfg.diameter)
    inv, fwd = T.make_planewave_pair(grid, cfg.n, sph, cfg.nb,
                                     backend=backend)
    rgrid = RG.choose_dft_grid(1, nbands=cfg.nb, diameter=cfg.diameter)
    rsph = R.SphereDomain.from_diameter(cfg.diameter)
    rinv, rfwd = R.make_planewave_pair(rgrid, cfg.n, rsph, cfg.nb,
                                       backend="matmul")
    assert sph.npacked == rsph.npacked
    rng = np.random.default_rng(0)
    c = (rng.standard_normal((cfg.nb, sph.npacked))
         + 1j * rng.standard_normal((cfg.nb, sph.npacked))
         ).astype(np.complex64)
    before = dict(sphere_pack.DISPATCHES)
    cube = inv.unpack_transform(torch.as_tensor(c))
    want = np.asarray(rinv.unpack_transform(jnp.asarray(c)))
    assert tuple(cube.shape) == (cfg.nb,) + (cfg.n,) * 3
    scale = float(np.abs(want).max())
    assert float(np.abs(cube.numpy() - want).max()) <= RTOL * scale
    back = fwd.transform_pack(cube)
    rback = np.asarray(rfwd.transform_pack(jnp.asarray(want)))
    assert float(np.abs(back.numpy() - rback).max()) <= \
        RTOL * float(np.abs(rback).max())
    # "cuda" took the fused route (kernels #3 and #4, their plain
    # versions on the CPU); "matmul" composed unpack, plan and pack
    fused = int(backend == "cuda")
    assert sphere_pack.DISPATCHES == {k: v + fused
                                      for k, v in before.items()}
    # the pair round-trips the packed coefficients (no extra scale)
    assert float(np.abs(back.numpy() - c).max()) <= \
        RTOL * float(np.abs(c).max())
