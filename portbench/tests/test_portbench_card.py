"""The harness on the card at toy sizes: the drivers, the hand-written
kernels and the checks, quickly.  Marked ``cuda``; skips without a card.

    python3 -m pytest -q -m cuda portbench/tests
"""
from __future__ import annotations

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.toy import toy


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paper-pair", "scf-fused",
                                  "paper-service"])
def test_cell_on_the_card_at_toy_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench, cfg, mix = toy(cell)
    line, _ = run_cell(bench, cell, 31, 1.0, True, "cuda", config=cfg,
                       traffic=mix)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
