"""The Γ-point fold and unfold: two real bands per complex transform.

At k = 0 a band's coefficients satisfy c(−G) = conj c(G), so a Γ-only
plane-wave code stores half the G-sphere and sends two real bands through
one complex FFT as ψ_a + iψ_b (Quantum ESPRESSO's ``gamma_only`` path).
Two hand-written CUDA kernels (``csrc/gamma.cu``) move between the two
forms, on packed lanes:

``fold``
    real-band half-sphere rows (nb, nhalf) to the ⌈nb/2⌉ complex
    full-sphere rows the plane-wave transform takes: a + i·b at G,
    conj(a) + i·conj(b) at −G; an odd last band pairs with a zero band.

``unfold``
    the transform's complex full-sphere rows back to the nb real bands:
    (F(G) + conj F(−G)) / 2 and (F(G) − conj F(−G)) / (2i).

Both take the same two (nhalf,) int32 tables: the full-sphere lane of each
half lane's G (``lane``) and of its −G (``mirror``).  They are bound by
bytes: each element of either side is read or written once, 2.25 GB a
128-row call of the paper's grid, 0.67 ms at 3.35 TB/s.

CUDA tensors launch the kernels (counted in ``fold.launches``,
``unfold.launches``); CPU tensors run the plain versions
(``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from . import build
from .dft_matmul import _check
from .ref import gamma_fold_plain, gamma_unfold_plain
from .sphere_pack import _launch

#: the largest row count a launch takes (the grid's y extent, 65535
#: blocks of 4 rows)
MAX_ROWS = 4 * 65535


def _check_tables(lane, mirror, nhalf: int, dev):
    _check("lane", lane, torch.int32, (nhalf,), dev)
    _check("mirror", mirror, torch.int32, (nhalf,), dev)


def fold(half, lane, mirror, npacked: int):
    """(nb, nhalf) complex64 real-band rows on the half sphere → (⌈nb/2⌉,
    npacked) complex64 full-sphere rows, every lane written."""
    nb, nhalf = half.shape
    rows = -(-nb // 2)
    dev = half.device
    _check("half", half, torch.complex64, (nb, nhalf), dev)
    _check_tables(lane, mirror, nhalf, dev)
    if dev.type != "cuda":
        return gamma_fold_plain(half, lane, mirror, npacked)
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed a launch's {MAX_ROWS}")
    out = torch.empty((rows, npacked), dtype=torch.complex64, device=dev)
    status = _launch(build.library("gamma").gamma_fold_launch, dev,
                     half.data_ptr(), lane.data_ptr(), mirror.data_ptr(),
                     out.data_ptr(), rows, nb, nhalf, npacked)
    build.check(status, "gamma_fold")
    fold.launches += 1
    return out


def unfold(full, lane, mirror, nb: int):
    """(rows, npacked) complex64 full-sphere rows → (nb, nhalf) complex64
    real-band rows on the half sphere, nb ≤ 2·rows (an odd nb drops the
    last row's second band)."""
    rows, npacked = full.shape
    nhalf = lane.shape[0]
    dev = full.device
    if not 2 * rows - 1 <= nb <= 2 * rows:
        raise ValueError(f"{nb} real bands do not fill {rows} complex rows")
    _check("full", full, torch.complex64, (rows, npacked), dev)
    _check_tables(lane, mirror, nhalf, dev)
    if dev.type != "cuda":
        return gamma_unfold_plain(full, lane, mirror, nb)
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed a launch's {MAX_ROWS}")
    out = torch.empty((nb, nhalf), dtype=torch.complex64, device=dev)
    status = _launch(build.library("gamma").gamma_unfold_launch, dev,
                     full.data_ptr(), lane.data_ptr(), mirror.data_ptr(),
                     out.data_ptr(), rows, nb, nhalf, npacked)
    build.check(status, "gamma_unfold")
    unfold.launches += 1
    return out


fold.launches = 0
unfold.launches = 0
