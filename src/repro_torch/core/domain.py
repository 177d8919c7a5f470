"""Bounded domains and sphere (plane-wave) domains with CSR offset arrays.

Paper §3.2/§3.3: tensors are declared over *domains* — cuboid volumes given by
two corner points, optionally carrying an *offset array* that compresses the
z-dimension per (x, y) column (a CSR-like format produced by projecting the
cut-off sphere onto the xy-plane, as in Quantum Espresso).

All index bookkeeping here is static numpy executed at *plan build time*.
The offset arrays are turned into static gather/scatter index tables used by
the pack/unpack stages and the fused sphere-pack kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Domain:
    """A cuboid domain given by inclusive corner points (paper Fig. 6)."""

    lower: tuple[int, ...]
    upper: tuple[int, ...]          # inclusive, as in the paper's API

    def __post_init__(self):
        if len(self.lower) != len(self.upper):
            raise ValueError("corner points must have equal rank")
        for lo, up in zip(self.lower, self.upper):
            if up < lo:
                raise ValueError(f"empty domain: {self.lower}..{self.upper}")

    @property
    def ndim(self) -> int:
        return len(self.lower)

    @property
    def extents(self) -> tuple[int, ...]:
        return tuple(u - l + 1 for l, u in zip(self.lower, self.upper))

    @property
    def npoints(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n


class SphereDomain(Domain):
    """A cut-off sphere inside a bounding cuboid, stored CSR-by-xy.

    ``offsets`` follows the paper's Figure 7: project the sphere points onto
    the xy-plane; for every (x, y) column inside the projection, store the
    z-extent ``[z_lo, z_hi)`` and the running offset of that column's points
    inside the packed coefficient vector.  The same offset array serves every
    wavefunction in the batch.
    """

    def __init__(self, radius: float, center: tuple[float, ...] | None = None,
                 lower: tuple[int, ...] | None = None,
                 upper: tuple[int, ...] | None = None):
        r = float(radius)
        if center is None:
            # diameter d = 2r grid points spanning [0, d-1]
            d = int(round(2 * r))
            c = (d - 1) / 2.0
            center = (c, c, c)
            lower = (0, 0, 0)
            upper = (d - 1, d - 1, d - 1)
        cx, cy, cz = center
        if lower is None:
            lower = (int(np.floor(cx - r + 0.5)), int(np.floor(cy - r + 0.5)),
                     int(np.floor(cz - r + 0.5)))
        if upper is None:
            upper = (int(np.ceil(cx + r - 0.5)), int(np.ceil(cy + r - 0.5)),
                     int(np.ceil(cz + r - 0.5)))
        super().__init__(tuple(lower), tuple(upper))
        object.__setattr__(self, "radius", r)
        object.__setattr__(self, "center", (cx, cy, cz))
        self._build_offsets()

    @staticmethod
    def from_diameter(d: int) -> "SphereDomain":
        """Sphere of diameter ``d`` grid points, bounding box [0, d-1]³."""
        return SphereDomain(radius=d / 2.0)

    # ------------------------------------------------------------------ CSR
    def _build_offsets(self) -> None:
        (xl, yl, zl), (xu, yu, zu) = self.lower, self.upper
        cx, cy, cz = self.center
        r2 = self.radius ** 2
        cols_x, cols_y, z_lo, z_hi = [], [], [], []
        for x in range(xl, xu + 1):
            for y in range(yl, yu + 1):
                h2 = r2 - (x - cx) ** 2 - (y - cy) ** 2
                if h2 < 0.0:
                    continue
                h = np.sqrt(h2)
                lo = max(zl, int(np.ceil(cz - h)))
                hi = min(zu, int(np.floor(cz + h)))
                if hi < lo:
                    continue
                cols_x.append(x); cols_y.append(y)
                z_lo.append(lo); z_hi.append(hi + 1)     # half-open
        self._col_x = np.asarray(cols_x, np.int32)
        self._col_y = np.asarray(cols_y, np.int32)
        self._z_lo = np.asarray(z_lo, np.int32)
        self._z_hi = np.asarray(z_hi, np.int32)
        lens = self._z_hi - self._z_lo
        self._row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    # Public CSR view — the paper's `offsets` argument.
    @property
    def offsets(self) -> dict[str, np.ndarray]:
        return {
            "col_x": self._col_x, "col_y": self._col_y,
            "z_lo": self._z_lo, "z_hi": self._z_hi,
            "row_ptr": self._row_ptr,
        }

    @property
    def ncols(self) -> int:
        return int(self._col_x.shape[0])

    @property
    def npacked(self) -> int:
        """Number of stored points (sphere interior) — the packed length."""
        return int(self._row_ptr[-1])

    # ------------------------------------------------- static index tables
    def pack_indices(self) -> np.ndarray:
        """Flat indices into the bounding cuboid (x, y, z C-order) for every
        packed coefficient, in CSR order.  Used by unpack (scatter) / pack
        (gather) stages; built once per plan.

        Vectorized over columns: column c contributes the run
        ``first_c, first_c + 1, …`` of length ``z_hi − z_lo``, where
        ``first_c`` is the flat index of its lowest z point."""
        ex, ey, ez = self.extents
        (xl, yl, zl) = self.lower
        lens = (self._z_hi - self._z_lo).astype(np.int64)
        first = (((self._col_x.astype(np.int64) - xl) * ey
                  + (self._col_y.astype(np.int64) - yl)) * ez
                 + (self._z_lo.astype(np.int64) - zl))
        return (np.repeat(first - self._row_ptr[:-1], lens)
                + np.arange(self.npacked, dtype=np.int64))

    def mask(self) -> np.ndarray:
        """Boolean occupancy mask of the bounding cuboid (x, y, z)."""
        m = np.zeros(self.extents, bool)
        m.reshape(-1)[self.pack_indices()] = True
        return m


def sphere_for_cutoff(n: int, diam_frac: float = 0.5) -> SphereDomain:
    """Sphere domain for a plane-wave FFT grid of linear size ``n``.

    The conventional setup (paper Fig. 2): the FFT grid has width twice the
    sphere diameter → diameter d = n/2 (`diam_frac` = d/n, default 1/2).
    """
    return SphereDomain.from_diameter(int(n * diam_frac))
