"""Inputs made from the seed: potentials, starting bands and request
schedules.  Every seed gets the same amount of work (the same sizes, the
same number of wells, the same multiset of request sizes and gaps); the
seed only places and orders it."""
from __future__ import annotations

import math

import numpy as np
import torch


def wells(n: int, centers, depth: float, width: float, device,
          dtype=torch.float32) -> torch.Tensor:
    """Sum of attractive Gaussian wells on the periodic n^3 grid (the
    distance to a centre is the shortest over the periodic images)."""
    x = torch.arange(n, dtype=torch.float64, device=device)
    v = torch.zeros((n, n, n), dtype=torch.float64, device=device)
    for c in centers:
        f = []
        for a in range(3):
            dx = torch.remainder(x - float(c[a]), n)
            dx = torch.minimum(dx, n - dx)
            f.append(torch.exp(-dx * dx / (2.0 * width * width)))
        v -= depth * f[0][:, None, None] * f[1][None, :, None] \
            * f[2][None, None, :]
    return v.to(dtype)


def seeded_wells(n: int, layout, depth: float, width: float, rng, device,
                 dtype=torch.float32) -> torch.Tensor:
    """``layout``'s wells (centres in units of n) moved together by one
    offset drawn from ``rng``: the same potential up to a translation."""
    shift = rng.uniform(0.0, n, size=3)
    centers = [tuple(float(p) * n + s for p, s in zip(c, shift))
               for c in layout]
    return wells(n, centers, depth, width, device, dtype)


def orthonormal_bands(nbands: int, npacked: int, gen, device
                      ) -> torch.Tensor:
    """``nbands`` orthonormal rows of ``npacked`` lanes, complex64: QR of
    a seeded complex normal block, in float64."""
    c = torch.randn((npacked, nbands), dtype=torch.complex128, device=device,
                    generator=gen)
    q, _ = torch.linalg.qr(c)
    return q.T.contiguous().to(torch.complex64)


def quotas(total: int, shares) -> list[int]:
    """Split ``total`` by ``shares`` into whole counts (largest
    remainder)."""
    shares = np.asarray(shares, np.float64)
    raw = total * shares / shares.sum()
    out = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - out), kind="stable")[:total - out.sum()]:
        out[i] += 1
    return out.tolist()


def schedule(rate: float, seconds: float, mix: dict, rng) -> list[dict]:
    """The open loop's requests for one window: ``round(rate * seconds)``
    of them, due over ``[0, seconds]``.

    Tenants, band counts and k-shifts come in fixed quotas of the mix's
    shares and the gaps are the quantiles of an exponential law (Poisson
    arrivals at ``rate``), so every seed sends the same work; the seed
    shuffles each list and picks the pool rows."""
    total = max(1, int(round(rate * seconds)))
    tenants = np.repeat(np.arange(len(mix["tenants"])),
                        quotas(total, mix["tenants"]))
    sizes = [int(b) for b in mix["bands"]]
    bands = np.repeat(sizes, quotas(total, list(mix["bands"].values())))
    nk = int(np.prod(mix["kpoint_mesh"]))
    kidx = np.arange(total) % nk
    gaps = -np.log1p(-(np.arange(total) + 0.5) / total)
    for a in (tenants, bands, kidx, gaps):
        rng.shuffle(a)
    due = seconds * np.cumsum(gaps) / gaps.sum()
    pool = int(mix["pool_rows"])
    return [{"due": float(due[i]), "tenant": int(tenants[i]),
             "bands": int(bands[i]), "sphere": int(kidx[i]),
             "row": int(rng.integers(0, pool - bands[i] + 1))}
            for i in range(total)]


def monkhorst_pack(mesh) -> list[tuple[float, float, float]]:
    """The k-shifts of an unshifted Monkhorst-Pack mesh, reduced units:
    u_r = (2r - q - 1) / (2q), r = 1..q, along each axis."""
    axes = [[(2 * r - q - 1) / (2.0 * q) for r in range(1, q + 1)]
            for q in mesh]
    return [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default); nan for no values."""
    if not len(values):
        return math.nan
    return float(np.percentile(np.asarray(values, np.float64), q))
