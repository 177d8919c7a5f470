"""The bf16 error of Mamba-2's placed first step against one process, by
depth: the port's held to the error model of ``tools/tp_bf16_depth.py``,
with the reference's at the same depths as the oracle of the spread.

Mamba-2 370M's reduced config in bf16 with remat "full", cut to 2 and 8
layers, 3 weight seeds each (the reference's ``PRNGKey(seed)`` weights,
carried over by ``params_from_numpy``; numpy's tokens): the port on a
2×2 grid of 4 CPU processes (gloo) against its own one-process step,
the reference on a 2×2 mesh of 4 forced host devices against its own
one-device step (``tools/tp_bf16_depth.py::measure``).

The model: the relative error of the first step's loss (grad_norm) is
normal with mean 0 and σ(L) = s·L^α (``CPU_MODEL``, fitted to 100 draws
of both packages at 2–48 layers); each draw lies within ``Z``·σ(L).  A
fault in the port's placed path (a partial sum rounded to bf16 that one
process keeps in float32, a statistic summed on the wrong axis) would
move its errors beyond the reference's spread: the port's errors, each
over σ(L), have an RMS within ``SPREAD`` times the reference's (with 6
draws a side, a ratio of RMS beyond 4 has a chance of 0.2% when both
come from one normal).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import tp_bf16_depth as depth  # noqa: E402

ARCH = "mamba2-370m"
DEPTHS, SEEDS = (2, 8), (0, 1, 2)
SPREAD = 4.0
KINDS = ("loss", "grad_norm")


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    res = depth.measure(ARCH, DEPTHS, SEEDS, str(tmp_path_factory.mktemp(
        "depth")), nice=19)
    return {side: depth.by_kind(res[side]) for side in res}


def _normalised(draws, kind):
    s, a = depth.CPU_MODEL[kind]
    return [x / (s * L ** a) for L, x in draws]


@pytest.mark.parametrize("side", ["port", "reference"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_depth_error_within_the_model(measured, side, kind):
    """Every draw within Z·σ(L), the port's and the reference's alike."""
    got = _normalised(measured[side][kind], kind)
    assert len(got) == len(DEPTHS) * len(SEEDS)
    assert all(abs(z) <= depth.Z[kind] for z in got), got


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_depth_port_spread_within_the_reference(measured, kind):
    port = depth._rms(_normalised(measured["port"][kind], kind))
    ref = depth._rms(_normalised(measured["reference"][kind], kind))
    assert 0 < port <= SPREAD * ref, (port, ref)


def test_module_imports_no_jax():
    src = open(depth.__file__).read()
    head = src[:src.index("def reference(")]
    assert "import jax" not in head and "from repro." not in head
