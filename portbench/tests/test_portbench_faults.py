"""Each cell's run with its timed path broken underneath comes out not
correct: the harness's look for a card skipped, the rest of a run driven
at toy size on the CPU, one planted fault at a time."""
from __future__ import annotations

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.toy import toy


def _run(cell: str, seconds: float = 0.5):
    bench, cfg, mix = toy(cell)
    line, _ = run_cell(bench, cell, 11, seconds, False, "cpu", config=cfg,
                       traffic=mix)
    return line


@pytest.mark.parametrize("cell", ["paper-pair", "scf-fused",
                                  "paper-service"])
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}


# -- the pair: the port's plane-wave wrappers, broken
def _pair_fault(kind):
    from repro_torch.core.planewave import _FusedTransformMixin as M
    inv0, fwd0 = M.unpack_transform, M.transform_pack

    def inv(self, packed, **kw):
        out = inv0(self, packed, **kw)
        if kind == "half":                 # half the batch left out
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        elif kind == "unchanged":          # the cube never written
            out = torch.zeros_like(out)
        return out

    def fwd(self, cube, **kw):
        out = fwd0(self, cube, **kw)
        if kind == "altered":              # one answer altered
            out = out.clone()
            out[0, 0] += 1e-3 * out.abs().max()
        return out
    return {"unpack_transform": inv, "transform_pack": fwd}


@pytest.mark.parametrize("kind", ["half", "unchanged", "altered"])
def test_pair_fault_is_caught(monkeypatch, kind):
    from repro_torch.core.planewave import _FusedTransformMixin
    for name, fn in _pair_fault(kind).items():
        monkeypatch.setattr(_FusedTransformMixin, name, fn)
    assert not _run("paper-pair")["correct"]


# -- the SCF: its band update, density and energy, broken
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_scf_fault_is_caught(monkeypatch, kind):
    from repro_torch.dft import scf
    if kind == "unchanged":                # the band update keeps its state
        def upd(basis, c_pad, v_eff, **kw):
            c, eps, n = orig(basis, c_pad, v_eff, **kw)
            return c_pad.clone(), eps, n
        orig = scf.update_bands_stacked
        monkeypatch.setattr(scf, "update_bands_stacked", upd)
    elif kind == "half":                   # half the bands left out of ρ
        def dens(basis, c_pad, occ, seg=0):
            c = c_pad.clone()
            c[:, c.shape[1] // 2:] = 0
            return 2.0 * orig(basis, c, occ, seg=seg)
        orig = scf.density_from_stacked
        monkeypatch.setattr(scf, "density_from_stacked", dens)
    else:                                  # the energy altered
        def energy(*a, **kw):
            return orig(*a, **kw) * (1.0 + 1e-4)
        orig = scf.total_energy_stacked
        monkeypatch.setattr(scf, "total_energy_stacked", energy)
    assert not _run("scf-fused")["correct"]


# -- the service: its dispatch's transform pair, broken
@pytest.mark.parametrize("kind", ["half", "unchanged", "altered"])
def test_service_fault_is_caught(monkeypatch, kind):
    from repro_torch.serve.transform_service import TransformService
    orig = TransformService._run_pair

    def run_pair(self, prepare):
        rows = {}

        def keep():
            inv, fwd, buf, v = prepare()
            rows["buf"] = buf
            return inv, fwd, buf, v
        out = orig(self, keep).clone()
        if kind == "half":
            out[out.shape[0] // 2:] = 0
        elif kind == "unchanged":          # the rows come back untouched
            out = rows["buf"].clone()
        else:
            out[0, 0] += 1e-3 * out.abs().max()
        return out
    monkeypatch.setattr(TransformService, "_run_pair", run_pair)
    bench, cfg, mix = toy("paper-service")
    mix["check_requests"] = 1000           # judge every request
    line, _ = run_cell(bench, "paper-service", 11, 0.5, False, "cpu",
                       config=cfg, traffic=mix)
    assert not line["correct"]
