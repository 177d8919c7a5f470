"""Fused sphere-pack kernels for the plane-wave hot path.

The Hamiltonian hot chain ``pack(F(v_eff · F⁻¹(unpack(c))))`` pays two full
``(B, d, d, d)`` bounding-cube materializations per sweep when composed:
``unpack`` scatters packed CSR coefficients into a zeroed cube that the
first line-DFT stage immediately re-reads, and ``pack`` gathers npacked
lanes back out of a cube the last stage just wrote.  Two hand-written CUDA
kernels (``csrc/sphere_pack.cu``) fuse those steps:

``unpack_dft``
    reads packed CSR lanes directly and applies the first rectangular
    (d→n, pad-fused) line DFT per bounding-box line, writing the
    first-stage slab ``(B, ex, ey, n)`` without materializing the cube.
    Lines of planes with ``flag[x] = 0``, and lines with no lanes, are
    not computed and come out exact +0.0.

``dft_pack``
    fuses the final truncating (n→d) line DFT with the CSR gather back to
    ``(B, npacked)``: each line's d outputs go straight to its packed
    lanes.  Lanes past a row's valid count (the padding of a ragged
    stacked batch) come out exact +0.0.

They replace the TPU kernels ``_unpack_dft_kernel`` and
``_dft_pack_kernel`` of the reference's ``kernels/sphere_pack.py``.  Each
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (same module) for CPU tensors; a CUDA tensor never takes the plain
version.

Index tables are static numpy built at plan time (`line_tables` /
`pack_gather_tables`), CSR-by-xy per ``SphereDomain.pack_indices``: packed
lanes of one (x, y) line are contiguous with z ascending, so a line is
``(start, z_lo, cnt)`` and its lanes are ``start + (z − z_lo)``.

What bounds them on an H100 is bytes.  At the shapes of the paper's grid
(z-lines of 128 ↔ 256, or 256 → 64: the longer length 256,
:func:`~.dft_matmul.factored_split`) each runs the factored line DFT of
kernel #1 (``csrc/cgemm_tc_factored.cuh``), two 16-point tensor-core
stages and a twiddle in one launch, 6,144 complex products a 128↔256 line
where the dense product takes 32,768: a 128-band ``unpack_dft`` moves
5.4 GB, 1.62 ms at 3.35 TB/s, against 0.62 ms of split-TF32 products.
The caller passes the factored operands (:func:`factored_for` chooses by
shape; ``factored=``), and the sphere stays in the kernel's policy: the
unpack brings each 32-line tile's lanes, one span in CSR order, by one
bulk copy and zeroes each line's elements outside its run; the pack reads
the slab by TMA where it lies, contiguous or as the plan's x stage leaves
it (z-major), and stores each line's outputs straight to its packed lanes.

Every other shape runs the dense tensor-core GEMM of ``csrc/cgemm_tc.cuh``
in split TF32 with the DFT matrix's split operand
(``kernels.ops.dft_operand_device``): ``unpack_dft`` gathers its lines'
lanes (each thread one complex of a line, a chunk ahead) and reads only
the K chunks that each 128-line tile's active lines cover
(:func:`chunk_ranges`); ``dft_pack`` reads the slab as the factored mode
does and stores in its epilogue.  The launches of each mode are counted
in :data:`MODES` (the ``sphere_pack`` probe).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..obs.metrics import global_metrics
from ..obs.trace import relayout
from . import build
from .dft_matmul import (Factored, _check, _check_factored, _operand,
                         cols_fit, dft_factored_plain, dft_matmul_plain,
                         factored_split)

#: process-wide counts of fused-kernel calls through the plane-wave
#: wrappers' ``unpack_transform``/``transform_pack`` (the reference's
#: ``DISPATCHES``); a CUDA launch is also counted on the wrapper itself
#: (``unpack_dft.launches``, ``dft_pack.launches``)
DISPATCHES = {"unpack_dft": 0, "dft_pack": 0}
#: the wrappers' calls by mode (the ``sphere_pack`` probe's counters of
#: the same names): "factored" the two 16-point stages, "dense" the
#: product with the DFT matrix; only the "cuda" backend calls the wrappers
MODES = {"unpack_factored": 0, "unpack_dense": 0, "pack_factored": 0,
         "pack_dense": 0}

global_metrics().register_probe("sphere_pack",
                                lambda: {**DISPATCHES, **MODES})


# --------------------------------------------------------------- tables
def line_tables(spheres, nbands: int):
    """Static per-row line tables for the fused unpack/pack kernels.

    For every sphere k and bounding-box line l = x·ey + y:
    ``start[k, l]`` — CSR lane of the line's first packed coefficient,
    ``zlo[k, l]`` — its z offset inside the box, ``cnt[k, l]`` — the line's
    packed length (0 outside the sphere's xy projection).  Tables are
    row-expanded to the stacked batch (row b belongs to sphere b // nbands)
    so the kernel needs no second indirection.  ``flag[x]`` is 1 iff *any*
    sphere has support in x-plane x — the zero-skip predicate must be
    conservative across the whole stacked batch.

    Returns ``(start, zlo, cnt, flag)``: three ``(len(spheres)·nbands, ex·ey)``
    int32 tables and an ``(ex, 1)`` int32 flag column.
    """
    spheres = list(spheres)
    if not spheres:
        raise ValueError("line_tables needs at least one sphere")
    ex, ey, ez = spheres[0].extents
    nlines = ex * ey
    nk = len(spheres)
    start = np.zeros((nk, nlines), np.int32)
    zlo = np.zeros((nk, nlines), np.int32)
    cnt = np.zeros((nk, nlines), np.int32)
    flag = np.zeros((ex, 1), np.int32)
    for k, s in enumerate(spheres):
        if s.extents != (ex, ey, ez):
            raise ValueError(f"sphere batch must share one bounding box; "
                             f"got {s.extents} vs {(ex, ey, ez)}")
        flat = s.pack_indices()
        lines = flat // ez
        # CSR order is line-major (columns ascend in (x, y)) with z
        # contiguous ascending inside each line
        uniq, first, counts = np.unique(lines, return_index=True,
                                        return_counts=True)
        start[k, uniq] = first
        zlo[k, uniq] = flat[first] % ez
        cnt[k, uniq] = counts
        flag[uniq // ey] = 1
    rep = functools.partial(np.repeat, repeats=nbands, axis=0)
    return rep(start), rep(zlo), rep(cnt), flag


def pack_gather_tables(spheres, nbands: int, npacked_max: int | None = None):
    """Static per-lane gather tables: the lane-centric view of the packing.

    Per padded lane p of sphere k: the bounding-box line ``line[k, p]`` and
    z offset ``z[k, p]`` the lane reads from, plus ``valid[k, p]`` (0 on
    padding).  Row-expanded to the stacked batch like :func:`line_tables`.
    The kernels run on the line-centric :func:`line_tables`; this is the
    inverse map they must agree with (``valid.sum(1)`` is the per-row valid
    lane count ``dft_pack`` takes).
    """
    spheres = list(spheres)
    if not spheres:
        raise ValueError("pack_gather_tables needs at least one sphere")
    ez = spheres[0].extents[2]
    if npacked_max is None:
        npacked_max = max(s.npacked for s in spheres)
    nk = len(spheres)
    line = np.zeros((nk, npacked_max), np.int32)
    zz = np.zeros((nk, npacked_max), np.int32)
    valid = np.zeros((nk, npacked_max), np.int32)
    for k, s in enumerate(spheres):
        flat = s.pack_indices()
        line[k, :s.npacked] = flat // ez
        zz[k, :s.npacked] = flat % ez
        valid[k, :s.npacked] = 1
    rep = functools.partial(np.repeat, repeats=nbands, axis=0)
    return rep(line), rep(zz), rep(valid)


#: the kernels' row tile (``tc::BM``) and K chunk in complex columns
#: (``tc::BK / 2``) of ``csrc/cgemm_tc.cuh``
TILE_ROWS, CHUNK = 128, 16


def chunk_ranges(zlo, cnt, flag):
    """The K chunks each 128-line tile of :func:`unpack_dft` reads.

    Rows are the (b, x, y) lines of the ``(B, ex·ey)`` tables, flattened
    and cut into tiles of ``TILE_ROWS``; a line is active when its plane's
    ``flag`` is set and ``cnt > 0``.  Returns a ``(tiles, 2)`` int32 tensor
    on the tables' device: the chunks ``[first, last)`` of ``CHUNK``
    complex columns that cover every active line's ``[zlo, zlo + cnt)`` in
    the tile, ``(0, 0)`` for a tile with no active line (which issues no
    load and no wgmma).  Every column outside that range is zero for every
    line of the tile, so skipping it leaves the result unchanged.
    """
    B, nl = zlo.shape
    ex = flag.numel()
    plane = torch.arange(nl, device=zlo.device) // (nl // ex)
    active = ((flag.reshape(-1)[plane] != 0)[None, :] & (cnt > 0)).reshape(-1)
    lo = torch.where(active, zlo.reshape(-1).long(),
                     torch.iinfo(torch.int64).max)
    hi = torch.where(active, (zlo + cnt).reshape(-1).long(), 0)
    pad = -(B * nl) % TILE_ROWS
    lo = torch.nn.functional.pad(lo, (0, pad), value=torch.iinfo(
        torch.int64).max).view(-1, TILE_ROWS).amin(1)
    hi = torch.nn.functional.pad(hi, (0, pad)).view(-1, TILE_ROWS).amax(1)
    on = hi > 0
    first = torch.where(on, lo // CHUNK, 0)
    last = torch.where(on, (hi + CHUNK - 1) // CHUNK, 0)
    return torch.stack((first, last), 1).to(torch.int32).contiguous()


#: the factored kernel's tile of lines (``tc::fct::TL``): #3's gather
#: brings one tile's lanes at once, so a row's lines fill whole tiles
FACTORED_TILE = 32


def factored_for(n_in: int, n_out: int, inverse: bool, lines: int,
                 device) -> Factored | None:
    """The operands with which #3 or #4 takes z-lines of ``n_in → n_out``
    in the factored mode, on rows of ``lines`` lines, or None for the
    dense mode: factored where :func:`~.dft_matmul.factored_split` takes
    the shape (as ``ops.dft_apply`` chooses for #1) and a row's lines fill
    whole tiles.  Cached per shape (``ops.factored_operands_device``)."""
    if factored_split(n_in, n_out) is None or lines % FACTORED_TILE:
        return None
    from .ops import factored_operands_device
    return factored_operands_device(n_out, n_in, bool(inverse),
                                    torch.device(device))


# ------------------------------------------------------ plain versions
def _line_masks(start, zlo, cnt, d):
    """(lane of each (row, line, z), z inside the line's packed run)."""
    z = torch.arange(d, device=start.device)
    zl = zlo.long()[..., None]
    inside = (z >= zl) & (z < zl + cnt.long()[..., None])
    return start.long()[..., None] + z - zl, inside


def _lines_plain(x, w, factored):
    """x's lines through the dense product with w or, given its
    operands, the factored mode's two stages."""
    if factored is None:
        return dft_matmul_plain(x, w)
    return dft_factored_plain(x, factored)


def unpack_dft_plain(packed, start, zlo, cnt, flag, w, factored=None):
    """Plain PyTorch version of :func:`unpack_dft` (same inputs/output),
    in the factored mode given its operands."""
    B, npk = packed.shape
    n, d = w.shape
    ex = flag.numel()
    nl = start.shape[1]
    ey = nl // ex
    plane = torch.arange(nl, device=start.device) // ey
    active = (flag.reshape(-1)[plane] != 0)[None, :] & (cnt > 0)  # (B, nl)
    lane, inside = _line_masks(start, zlo, cnt, d)
    sel = inside & active[..., None]
    lane = lane.clamp(0, max(npk - 1, 0)).reshape(B, nl * d)
    zero = torch.zeros((), dtype=torch.complex64, device=packed.device)
    lines = torch.where(sel, torch.gather(packed, 1, lane).reshape(B, nl, d),
                        zero)
    y = _lines_plain(lines.reshape(B * nl, d), w, factored).reshape(B, nl, n)
    y = torch.where(active[..., None], y, zero)     # literal +0.0 lines
    return y.reshape(B, ex, ey, n)


def dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npacked: int,
                   factored=None):
    """Plain PyTorch version of :func:`dft_pack` (same inputs/output), in
    the factored mode given its operands."""
    B, ex, ey, n = slab.shape
    d = w.shape[0]
    nl = ex * ey
    y = _lines_plain(slab.reshape(B * nl, n), w, factored).reshape(B, nl, d)
    lane, inside = _line_masks(start, zlo, cnt, d)
    rows = torch.arange(B, device=slab.device)[:, None, None].expand(
        B, nl, d)
    out = torch.zeros((B, npacked), dtype=torch.complex64,
                      device=slab.device)
    out[rows[inside], lane[inside]] = y[inside]
    keep = (torch.arange(npacked, device=slab.device)[None, :]
            < nvalid.long()[:, None])
    return torch.where(keep, out, torch.zeros_like(out[:1, :1]))


# ------------------------------------------------------------- wrappers
def _check_tables(dev, B, nl, **tables):
    for name, t in tables.items():
        _check(name, t, torch.int32, (B, nl), dev)


def _launch(fn, dev, *args):
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        return fn(*args, stream)


def _check_lines(factored: Factored, n_in: int, n_out: int, lines: int):
    """Raise unless ``factored`` holds the operands of n_in → n_out lines
    and a row's ``lines`` fill whole tiles of the factored kernel."""
    n1, n2 = factored.t.shape
    if (factored.f1.shape[1] * n1, factored.f2.shape[0] * n2) != (n_in,
                                                                  n_out):
        raise ValueError(f"factored operands for {factored.f1.shape[1] * n1}"
                         f" -> {factored.f2.shape[0] * n2} lines, not "
                         f"{n_in} -> {n_out}")
    if lines % FACTORED_TILE:
        raise ValueError(f"{lines} lines a row do not fill whole tiles of "
                         f"{FACTORED_TILE}")


def unpack_dft(packed, start, zlo, cnt, flag, w, *, chunks=None,
               wsplit=None, factored: Factored | None = None):
    """Fused CSR-unpack + first-stage line DFT.

    ``packed``: (B, npacked) complex64 lanes (lanes past a row's sphere are
    never read); ``start``/``zlo``/``cnt``: (B, ex·ey) int32 line tables;
    ``flag``: (ex, 1) int32 plane-support column; ``w``: (n, d) complex64
    rectangular DFT factor.  Returns the first-stage slab (B, ex, ey, n)
    complex64.  Given ``factored``, the operands of the same operator
    (:func:`factored_for`), the call takes the factored mode; else the
    dense one, with ``chunks = chunk_ranges(zlo, cnt, flag)`` and
    ``wsplit = embed_operand(w)``, each built per call unless the caller
    passes a cached one.  CUDA tensors launch the kernel (counted in
    ``unpack_dft.launches``); CPU tensors run :func:`unpack_dft_plain`.
    The call is counted in :data:`MODES` either way.
    """
    B, npk = packed.shape
    n, d = w.shape
    ex = flag.shape[0]
    nl = start.shape[1]
    if nl % ex:
        raise ValueError(f"{nl} lines do not split into {ex} x-planes")
    ey = nl // ex
    dev = packed.device
    _check("packed", packed, torch.complex64, (B, npk), dev)
    _check("w", w, torch.complex64, (n, d), dev)
    _check_tables(dev, B, nl, start=start, zlo=zlo, cnt=cnt)
    flag = flag.reshape(ex)
    _check("flag", flag, torch.int32, (ex,), dev)
    if factored is not None:
        _check_lines(factored, d, n, nl)
    MODES["unpack_dense" if factored is None else "unpack_factored"] += 1
    if dev.type != "cuda":
        return unpack_dft_plain(packed, start, zlo, cnt, flag, w, factored)
    y = torch.empty((B, ex, ey, n), dtype=torch.complex64, device=dev)
    lib = build.library("sphere_pack")
    if factored is not None:
        _check_factored(factored, d, dev)
        if packed.data_ptr() % 16 or packed.numel() % 2:
            # the kernel's bulk copy reads whole 16 bytes from a 16-byte
            # aligned base
            buf = torch.empty(packed.numel() + 1, dtype=packed.dtype,
                              device=dev)
            buf[:-1] = packed.reshape(-1)
            packed = buf[:-1].view(B, npk)
        status = _launch(lib.unpack_factored_launch, dev, packed.data_ptr(),
                         start.data_ptr(), zlo.data_ptr(), cnt.data_ptr(),
                         flag.data_ptr(), factored.ops.data_ptr(),
                         factored.t.data_ptr(), y.data_ptr(), B, npk, ex, ey,
                         n, d)
    else:
        if chunks is None:
            chunks = chunk_ranges(zlo, cnt, flag)
        _check("chunks", chunks, torch.int32, (-(-B * nl // TILE_ROWS), 2),
               dev)
        ws = _operand(w, wsplit, n, d, dev)
        status = _launch(lib.unpack_dft_launch, dev, packed.data_ptr(),
                         start.data_ptr(), zlo.data_ptr(), cnt.data_ptr(),
                         flag.data_ptr(), chunks.data_ptr(), ws.data_ptr(),
                         y.data_ptr(), B, npk, ex, ey, n, d)
    build.check(status, "unpack_dft")
    unpack_dft.launches += 1
    return y


def slab_layout(slab) -> int | None:
    """How the kernel of :func:`dft_pack` reads a (B, ex, ey, n) slab where
    it lies: 0 when its lines are contiguous; 1 when each y plane is
    stored z-major, x fastest ((B, ey, n, ex) in memory) and a plane's ex
    lines fit the kernel's tile; 2 when each row's slab is stored z-major,
    then y, then x ((B, n, ey, ex) in memory: what a forward plan whose
    last stage before the fused one is the x stage leaves, its line stages
    keeping the other dims in memory order) and a row's ex·ey lines fit
    the tile; None otherwise (the wrapper then copies the slab)."""
    B, ex, ey, n = slab.shape
    if slab.is_contiguous():
        return 0
    if cols_fit(ex) and slab.permute(0, 2, 3, 1).is_contiguous():
        return 1
    if cols_fit(ex * ey) and slab.permute(0, 3, 2, 1).is_contiguous():
        return 2
    return None


def dft_pack(slab, start, zlo, cnt, nvalid, w, npacked: int, *,
             wsplit=None, partial: bool = False,
             factored: Factored | None = None):
    """Fused final truncating line DFT + CSR pack.

    ``slab``: (B, ex, ey, n) complex64 last-stage slab, its lines
    contiguous, each y plane z-major or each row's slab z-major
    (:func:`slab_layout`; any other layout is copied first);
    ``start``/``zlo``/``cnt``: (B, ex·ey) int32 line tables; ``nvalid``:
    (B,) int32 valid lanes per row; ``w``: (d, n) complex64 truncating DFT
    factor.  Returns (B, npacked) complex64 packed lanes, exact +0.0 past
    ``nvalid``.  ``factored`` and ``wsplit`` choose the mode as in
    :func:`unpack_dft`.  CUDA tensors launch the kernel (counted in
    ``dft_pack.launches``); CPU tensors run :func:`dft_pack_plain`.

    ``partial=True`` says the slab holds only some of each row's lines (a
    rank's x planes, the tables cut to them): the lanes of the other lines
    are then written +0.0 too, so that summing the ranks' outputs gives
    every lane once.  The kernel stores only its own lines' lanes and the
    tail past ``nvalid``, so the wrapper zero-fills the output first (one
    memset of the output, against a kernel that reads the whole slab); the
    plain version always writes +0.0 to the lanes no line covers.
    """
    B, ex, ey, n = slab.shape
    d = w.shape[0]
    nl = ex * ey
    dev = slab.device
    if slab.dtype != torch.complex64:
        raise TypeError(f"slab: dtype {slab.dtype}, expected complex64")
    _check("w", w, torch.complex64, (d, n), dev)
    _check_tables(dev, B, nl, start=start, zlo=zlo, cnt=cnt)
    _check("nvalid", nvalid, torch.int32, (B,), dev)
    if factored is not None:
        _check_lines(factored, n, d, nl)
    MODES["pack_dense" if factored is None else "pack_factored"] += 1
    if dev.type != "cuda":
        return dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npacked,
                              factored)
    layout = slab_layout(slab)
    if layout is None:
        slab, layout = relayout(slab), 0
    out = (torch.zeros if partial else torch.empty)(
        (B, npacked), dtype=torch.complex64, device=dev)
    lib = build.library("sphere_pack")
    if factored is not None:
        _check_factored(factored, n, dev)
        if slab.data_ptr() % 16:         # TMA reads 16-byte aligned lines
            slab, layout = slab.clone(
                memory_format=torch.contiguous_format), 0
        status = _launch(lib.pack_factored_launch, dev, slab.data_ptr(),
                         start.data_ptr(), zlo.data_ptr(), cnt.data_ptr(),
                         nvalid.data_ptr(), factored.ops.data_ptr(),
                         factored.t.data_ptr(), out.data_ptr(), B, npacked,
                         ex, ey, n, d, layout)
    else:
        ws = _operand(w, wsplit, d, n, dev)
        status = _launch(lib.dft_pack_launch, dev, slab.data_ptr(),
                         start.data_ptr(), zlo.data_ptr(), cnt.data_ptr(),
                         nvalid.data_ptr(), ws.data_ptr(), out.data_ptr(), B,
                         npacked, ex, ey, n, d, layout)
    build.check(status, "dft_pack")
    dft_pack.launches += 1
    return out


unpack_dft.launches = 0
dft_pack.launches = 0
