"""The control of each cell, at toy size on the CPU: the reference one
precision lower (TF32 transforms) in the program's place fails the cell's
limits, while the program's runs on the same seeds pass them."""
from __future__ import annotations

import pytest

from portbench.limits import readings
from portbench.tests.toy import toy


@pytest.mark.parametrize("cell", ["paper-pair", "scf-fused",
                                  "paper-service"])
def test_control_fails_and_program_passes(cell):
    bench, cfg, mix = toy(cell)
    out = readings(bench, cell, [21, 22], [121], 0.5, "cpu", config=cfg,
                   traffic=mix)
    limits = mix["limits"]
    for seed, nums in out["program"].items():
        for name, value in nums.items():
            assert value <= limits[name], (seed, name, value)
    for seed, nums in out["control"].items():
        assert any(v > limits[k] for k, v in nums.items()), (seed, nums)
