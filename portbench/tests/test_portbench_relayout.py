"""The relayout readers on the toy pair, traced on the CPU.

``relayout_gb.pair`` is held against twice the bytes of the line-stage
inputs that the "cuda" route cannot view in place, worked out from the
pair's stages and shapes alone; ``relayout_ms.pair`` reads nothing off
CUDA, where the program records no device time."""
from __future__ import annotations

import math

import pytest

from portbench import registry
from portbench.run import run_cell
from portbench.tests.toy import toy


def _copied_bytes(stages, shape, order):
    """(bytes, shape, order) after ``stages`` from a complex64 block of
    ``shape`` whose dims lie in memory ``order`` (outermost first): a
    line stage copies its input unless the other dims lie in logical
    order with its own dim innermost (dims of size 1 aside), and leaves
    its output so; a move over one process is the identity."""
    from repro_torch.core.plan import FFTStage
    shape, order, total = list(shape), list(order), 0
    for st in stages:
        if not isinstance(st, FFTStage):
            continue
        want = [d for d in range(len(shape)) if d != st.index] + [st.index]
        if ([d for d in order if shape[d] > 1]
                != [d for d in want if shape[d] > 1]):
            total += 8 * math.prod(shape)
        order = want
        shape[st.index] = st.n_out
    return total, shape, order


def _pair_bytes(cfg) -> int:
    """The copied bytes of one toy pair: per call, the inverse's stages
    after the fused unpack (a contiguous slab, z innermost), then the
    forward's before the fused pack, from the cube the inverse left."""
    from repro_torch.core import ProcGrid, make_planewave_pair
    from repro_torch.core.planewave import kpoint_sphere
    batch = int(cfg["band_batch"])
    inv, fwd = make_planewave_pair(
        ProcGrid.create(list(cfg["grid"]), device="cpu"), int(cfg["n"]),
        kpoint_sphere(int(cfg["diameter"])), batch, backend=cfg["backend"])
    ex, ey, _ = inv.sphere.extents
    slab = (batch, ex, ey, inv.plan.stages[0].n_out)
    b_inv, cube, order = _copied_bytes(inv.plan.stages[1:], slab, range(4))
    b_fwd, _, _ = _copied_bytes(fwd.plan.stages[:-1], cube, order)
    return (b_inv + b_fwd) * (int(cfg["nb"]) // batch)


def test_relayout_readers_on_the_toy_pair():
    bench, cfg, mix = toy("paper-pair")
    names = {m["name"] for m in registry.per_layer(bench, "paper-pair")}
    assert {"relayout_ms.pair", "relayout_gb.pair"} <= names
    line, _ = run_cell(bench, "paper-pair", 2 ** 31 + 7, 0.3, True, "cpu",
                       config=cfg, traffic=mix)
    assert line["correct"]
    per_pair = _pair_bytes(cfg)
    assert per_pair > 0
    got = line["metrics"]["relayout_gb.pair"]
    assert got["unit"] == "GB"
    assert got["value"] == pytest.approx(2 * per_pair / 1e9, rel=1e-12)
    assert "relayout_ms.pair" not in line["metrics"]


def test_relayout_readers_find_nothing_untraced():
    bench, cfg, mix = toy("paper-pair")
    line, _ = run_cell(bench, "paper-pair", 5, 0.2, False, "cpu",
                       config=cfg, traffic=mix)
    facts = {"trace": None, "pairs": line["attempted"]}
    for name in ("relayout_ms.pair", "relayout_gb.pair"):
        assert registry.reader(name)(facts) is None
