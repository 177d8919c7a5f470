"""The plain reference the benchmark judges the port against.

Plain PyTorch and NumPy only: it imports nothing of the program and takes
none of its tables.  Everything here is re-derived from the problem's
definition:

* a cut-off sphere of diameter ``d`` inside the bounding cube ``[0, d)^3``,
  centred at ``(d - 1) / 2 + k`` for a k-shift ``k``, stored column by
  column over (x, y) with z ascending (the CSR order of plane-wave codes);
* the inverse transform of packed coefficients is ``ifftn`` (scaled by
  ``1 / n^3``) of the coefficients zero-padded into the corner ``[0, d)^3``
  of the ``n^3`` cube; the forward transform is the unscaled ``fftn`` of a
  cube, truncated to that corner and gathered back to the lanes;
* the plane-wave SCF: kinetic diagonal ``|G + k|^2 / 2``, Hartree by the
  periodic Poisson kernel ``4 pi / |G|^2``, Slater exchange, the locally
  optimal preconditioned band update with a Rayleigh-Ritz solve in the
  span of the bands and their residuals, and linear then Anderson mixing.

Two precisions: the reference itself (float64 and ``torch.fft``), and the
control (``precision="tf32"``): the same staged transform as line DFTs by
matrix products whose operands are rounded to TF32, the precision one step
below the configuration's float32, with every other operation in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: Slater exchange constant C_x = (3/4)(3/pi)^(1/3)
CX = 0.75 * (3.0 / math.pi) ** (1.0 / 3.0)


# ------------------------------------------------------------------ sphere
class Sphere:
    """Lanes of a cut-off sphere of diameter ``d`` shifted by ``kpt``."""

    def __init__(self, d: int, kpt=(0.0, 0.0, 0.0)):
        self.d = int(d)
        r = self.d / 2.0
        c0 = (self.d - 1) / 2.0
        self.center = tuple(c0 + float(k) for k in kpt)
        cx, cy, cz = self.center
        x, y = np.meshgrid(np.arange(self.d), np.arange(self.d),
                           indexing="ij")
        x, y = x.ravel(), y.ravel()
        h2 = r * r - (x - cx) ** 2 - (y - cy) ** 2
        inside = h2 >= 0.0
        h = np.sqrt(np.where(inside, h2, 0.0))
        lo = np.maximum(0, np.ceil(cz - h)).astype(np.int64)
        hi = np.minimum(self.d - 1, np.floor(cz + h)).astype(np.int64)
        keep = inside & (hi >= lo)
        self.col_x, self.col_y = x[keep], y[keep]
        self.z_lo, self.z_hi = lo[keep], hi[keep] + 1
        lens = self.z_hi - self.z_lo
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        first = (self.col_x * self.d + self.col_y) * self.d + self.z_lo
        #: flat index into the d^3 box of every lane, in lane order
        self.lanes = (np.repeat(first - starts, lens)
                      + np.arange(int(lens.sum()), dtype=np.int64))

    @property
    def npacked(self) -> int:
        return int(self.lanes.shape[0])

    @property
    def ncols(self) -> int:
        """(x, y) columns that hold lanes: the z lines a transform needs."""
        return int(self.col_x.shape[0])

    def gvectors(self) -> np.ndarray:
        """(npacked, 3) offsets of each lane from the centre, float64."""
        d = self.d
        idx = np.stack([self.lanes // (d * d), (self.lanes // d) % d,
                        self.lanes % d], axis=1).astype(np.float64)
        return idx - np.asarray(self.center)

    def kinetic(self, box: float) -> np.ndarray:
        """|G + k|^2 / 2 per lane, float64, for a cubic cell of side box."""
        g = self.gvectors()
        return 0.5 * (g ** 2).sum(1) * (2.0 * math.pi / box) ** 2


# ---------------------------------------------------------------- transforms
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32 (10 mantissa bits), nearest with ties
    away from zero, as the tensor cores' ``cvt.rna.tf32.f32`` does."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_complex(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(tf32_round(x.real.contiguous()),
                         tf32_round(x.imag.contiguous()))


class Transforms:
    """The sphere <-> cube transforms at one precision.

    ``precision="float64"``: ``torch.fft`` in complex128.  ``"tf32"``: the
    staged transform (z, y, x line DFTs, the pad or the truncation fused
    into rectangular DFT matrices) as complex64 products of TF32-rounded
    operands accumulated in float32.
    """

    def __init__(self, n: int, d: int, device, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.n, self.d = int(n), int(d)
        self.device = torch.device(device)
        self.precision = precision
        self.cdtype = (torch.complex128 if precision == "float64"
                       else torch.complex64)
        self.rdtype = (torch.float64 if precision == "float64"
                       else torch.float32)
        if precision == "tf32":
            j = np.arange(self.n)
            k = np.arange(self.d)
            w_inv = np.exp(2j * np.pi * np.outer(j, k) / self.n) / self.n
            w_fwd = np.exp(-2j * np.pi * np.outer(k, j) / self.n)
            self.w_inv = _tf32_complex(torch.as_tensor(
                w_inv.astype(np.complex64), device=self.device))
            self.w_fwd = _tf32_complex(torch.as_tensor(
                w_fwd.astype(np.complex64), device=self.device))

    # one line-DFT stage of the control: y = x @ W^T along ``axis``
    def _line(self, x, axis: int, w):
        xm = torch.movedim(x, axis, -1)
        xm = _tf32_complex(xm)
        xr, xi = xm.real, xm.imag
        wr, wi = w.real.T, w.imag.T
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            y = torch.complex(xr @ wr - xi @ wi, xr @ wi + xi @ wr)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return torch.movedim(y, -1, axis)

    def unpack(self, c, sphere: Sphere):
        """(B, npacked) lanes -> (B, d, d, d) box, zeros elsewhere."""
        d = self.d
        lanes = torch.as_tensor(sphere.lanes, device=self.device)
        box = torch.zeros((c.shape[0], d ** 3), dtype=self.cdtype,
                          device=self.device)
        box[:, lanes] = c.to(self.cdtype)
        return box.reshape(c.shape[0], d, d, d)

    def pack(self, box, sphere: Sphere):
        """(B, d, d, d) box -> (B, npacked) lanes."""
        lanes = torch.as_tensor(sphere.lanes, device=self.device)
        return box.reshape(box.shape[0], -1)[:, lanes]

    def inverse(self, c, sphere: Sphere):
        """(B, npacked) coefficients -> (B, n, n, n) real-space cube."""
        n, d = self.n, self.d
        box = self.unpack(c, sphere)
        if self.precision == "tf32":
            for axis in (3, 2, 1):
                box = self._line(box, axis, self.w_inv)
            return box
        cube = torch.zeros((c.shape[0], n, n, n), dtype=self.cdtype,
                           device=self.device)
        cube[:, :d, :d, :d] = box
        return torch.fft.ifftn(cube, dim=(1, 2, 3))

    def forward(self, cube, sphere: Sphere):
        """(B, n, n, n) cube -> (B, npacked) truncated spectrum lanes."""
        d = self.d
        cube = cube.to(self.cdtype)
        if self.precision == "tf32":
            for axis in (1, 2, 3):
                cube = self._line(cube, axis, self.w_fwd)
            return self.pack(cube, sphere)
        spec = torch.fft.fftn(cube, dim=(1, 2, 3))[:, :d, :d, :d]
        return self.pack(spec, sphere)

    def round_trip(self, c, sphere: Sphere, v=None):
        """pack(F(v * F^-1(unpack(c)))); the identity on the lanes when
        ``v`` is None."""
        psi = self.inverse(c, sphere)
        if v is not None:
            psi = psi * v.to(self.rdtype)
        return self.forward(psi, sphere)


class GapMeter:
    """:func:`gap` over blocks: the widest gap of any block against the
    largest reference value of all of them."""

    def __init__(self):
        self.diff = 0.0
        self.scale = 0.0

    def add(self, got, ref) -> None:
        ref = torch.as_tensor(ref)
        got = torch.as_tensor(got).to(device=ref.device)
        wide = (torch.complex128 if ref.is_complex() or got.is_complex()
                else torch.float64)
        ref, got = ref.to(wide), got.to(wide)
        if ref.numel():
            self.diff = max(self.diff, float((got - ref).abs().max()))
            self.scale = max(self.scale, float(ref.abs().max()))

    @property
    def value(self) -> float:
        if self.scale == 0.0:
            return 0.0 if self.diff == 0.0 else math.inf
        return self.diff / self.scale


def gap(got, ref) -> float:
    """max |got - ref| / max |ref|: the widest gap, against the largest
    reference value (0 when both are zero)."""
    m = GapMeter()
    m.add(got, ref)
    return m.value


# ----------------------------------------------------------------------- SCF
class SCF:
    """The plane-wave SCF, iteration by iteration.

    Follows the configuration's algorithm from the benchmark's own start
    (the external potential and the orthonormal starting bands): build
    ``v_eff``, update the bands (``inner_steps`` locally optimal steps per
    iteration), rebuild the density, take the total energy and the density
    residual, mix.  Bands go through the transforms ``block`` rows at a
    time, so a full-size cube never holds every band at once.
    """

    def __init__(self, cfg: dict, v_ext, coeffs, device, *,
                 precision: str = "float64", block: int = 8):
        self.n = int(cfg["n"])
        self.d = int(cfg["diameter"])
        self.nb = int(cfg["nbands"])
        self.kpts = [tuple(k) for k in cfg["kpts"]]
        self.box = float(cfg.get("L") or self.n)
        self.steps = int(cfg["inner_steps"])
        self.alpha = float(cfg["mix_alpha"])
        self.history = int(cfg["mix_history"])
        self.warmup = int(cfg["mix_warmup"])
        self.xc = bool(cfg["xc"])
        self.block = int(block)
        self.dev = torch.device(device)
        self.tf = Transforms(self.n, self.d, self.dev, precision)
        self.rdtype, self.cdtype = self.tf.rdtype, self.tf.cdtype
        self.spheres = [Sphere(self.d, k) for k in self.kpts]
        self.weights = [1.0 / len(self.kpts)] * len(self.kpts)
        self.dv = (self.box / self.n) ** 3
        self.nelec = float(sum(self.weights) * self.nb)
        self.kin = [torch.as_tensor(s.kinetic(self.box), dtype=self.rdtype,
                                    device=self.dev) for s in self.spheres]
        self.pre = [1.0 / (1.0 + k) for k in self.kin]
        f = np.fft.fftfreq(self.n, d=1.0 / self.n)
        g2 = ((f[:, None, None] ** 2 + f[None, :, None] ** 2
               + f[None, None, :] ** 2) * (2 * math.pi / self.box) ** 2)
        kern = np.where(g2 > 0, 4 * math.pi / np.where(g2 > 0, g2, 1.0), 0.0)
        self.coulomb = torch.as_tensor(kern, dtype=self.rdtype,
                                       device=self.dev)
        self.v_ext = torch.as_tensor(v_ext, device=self.dev).to(self.rdtype)
        self.c = [torch.as_tensor(c, device=self.dev).to(self.cdtype)
                  for c in coeffs]
        self.rho = self.density(self.c)
        self._rho_hist: list = []
        self._res_hist: list = []
        self._seen = 0

    # -- fields
    def density(self, cs):
        rho = torch.zeros((self.n,) * 3, dtype=self.rdtype, device=self.dev)
        for ik, c in enumerate(cs):
            for b0 in range(0, c.shape[0], self.block):
                psi = self.tf.inverse(c[b0:b0 + self.block], self.spheres[ik])
                rho += self.weights[ik] * (psi.abs() ** 2).sum(0)
                del psi
        return rho * (self.n ** 3 / self.dv)

    def hartree(self, rho):
        spec = torch.fft.fftn(rho.to(self.cdtype)) * self.coulomb
        return torch.fft.ifftn(spec).real

    def exchange(self, rho):
        r = torch.clamp(rho, min=0.0)
        r13 = torch.pow(r, 1.0 / 3.0)
        return -CX * r13 * r, -(4.0 / 3.0) * CX * r13

    # -- bands
    def apply_h(self, ik: int, c, v_eff):
        out = torch.empty_like(c)
        s = self.spheres[ik]
        for b0 in range(0, c.shape[0], self.block):
            blk = c[b0:b0 + self.block]
            out[b0:b0 + self.block] = self.tf.round_trip(blk, s, v_eff)
        return self.kin[ik][None, :] * c + out

    @staticmethod
    def _orthonormalize(c):
        q, _ = torch.linalg.qr(c.T)
        return q.T

    def update_bands(self, ik: int, c, v_eff):
        pre = self.pre[ik]
        eps = None
        for _ in range(self.steps):
            hc = self.apply_h(ik, c, v_eff)
            lam = torch.sum(c.conj() * hc, dim=-1).real
            grad = hc - lam[:, None] * c
            dd = pre[None, :] * grad
            ovl = c.conj() @ dd.T                       # <c_i|d_j>
            dd = self._orthonormalize(dd - ovl.T @ c)
            hd = self.apply_h(ik, dd, v_eff)
            bb = torch.cat([c, dd])
            hb = torch.cat([hc, hd])
            hmat = bb.conj() @ hb.T
            hmat = 0.5 * (hmat + hmat.T.conj())
            e, vecs = torch.linalg.eigh(hmat)
            c = self._orthonormalize(vecs[:, :self.nb].T @ bb)
            eps = e[:self.nb]
        return c, eps

    # -- one iteration
    def energy(self, cs, rho):
        e_kin = sum(w * float(torch.sum(k[None, :] * c.abs() ** 2))
                    for w, k, c in zip(self.weights, self.kin, cs))
        e_ext = float(torch.sum(rho * self.v_ext)) * self.dv
        e_h = 0.5 * float(torch.sum(rho * self.hartree(rho))) * self.dv
        e_xc = (float(torch.sum(self.exchange(rho)[0])) * self.dv
                if self.xc else 0.0)
        return e_kin + e_ext + e_h + e_xc

    def mix(self, rho_in, rho_out):
        res = rho_out - rho_in
        self._seen += 1
        self._rho_hist = (self._rho_hist + [rho_in])[-self.history:]
        self._res_hist = (self._res_hist + [res])[-self.history:]
        m = len(self._res_hist)
        linear = rho_in + self.alpha * res
        if self.history <= 1 or self._seen <= self.warmup or m < 2:
            return linear
        r = torch.stack([x.reshape(-1) for x in self._res_hist])
        a = torch.zeros((m + 1, m + 1), dtype=torch.float64, device=self.dev)
        a[:m, :m] = (r @ r.T).to(torch.float64)
        a[m, :m] = a[:m, m] = 1.0
        rhs = torch.zeros(m + 1, dtype=torch.float64, device=self.dev)
        rhs[m] = 1.0
        beta = torch.linalg.solve(a, rhs)[:m]
        if not bool(torch.isfinite(beta).all()):
            return linear
        beta = beta.to(self.rdtype)
        return sum(b * (x + self.alpha * y) for b, x, y
                   in zip(beta, self._rho_hist, self._res_hist))

    def iterate(self):
        """One SCF iteration; returns (energy, residual)."""
        rho = self.rho
        v_eff = self.v_ext + self.hartree(rho)
        if self.xc:
            v_eff = v_eff + self.exchange(rho)[1]
        self.c = [self.update_bands(ik, c, v_eff)[0]
                  for ik, c in enumerate(self.c)]
        rho_out = self.density(self.c)
        energy = self.energy(self.c, rho_out)
        resid = (float(torch.sqrt(torch.sum((rho_out - rho) ** 2)))
                 * self.dv ** 0.5 / max(self.nelec, 1e-9))
        self.rho = self.mix(rho, rho_out)
        return energy, resid
