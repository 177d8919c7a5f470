"""repro_torch on the card: each hand-written CUDA kernel against its plain
PyTorch version, and the SCF slice on the kernel route.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import neither JAX nor the reference package, so they run
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: kernel and plain version are both fp32 and sum in different
orders; outputs agree to 1e-5 relative to the largest magnitude.  Exact
zeros (padded lanes) are compared bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kpoint_sphere
from repro_torch.core.local_fft import dft_matrix_device
from repro_torch.dft import SCFConfig, run_scf
from repro_torch.kernels import sphere_pack as sp
from repro_torch.kernels.dft_matmul import dft_matmul, dft_matmul_plain

KPTS2 = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _cx(rng, shape, dev):
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)
                            ).astype(np.complex64), device=dev)


def _close(got, want, rtol=RTOL):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= rtol * max(float(want.abs().max()), 1e-30), err


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dft_matmul", "unpack_dft", "dft_pack"])
def test_cuda_kernel_matches_plain(kernel, cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(11)
    spheres = [kpoint_sphere(8, k) for k in KPTS2]
    nb = 3
    npm = max(s.npacked for s in spheres)
    tabs = tuple(torch.as_tensor(t, device=dev)
                 for t in sp.line_tables(spheres, nb))
    fn = {"dft_matmul": dft_matmul, "unpack_dft": sp.unpack_dft,
          "dft_pack": sp.dft_pack}[kernel]
    before = fn.launches
    if kernel == "dft_matmul":
        x = _cx(rng, (1000, 24), dev)
        _, _, w = dft_matrix_device(40, 24, True, dev)
        _close(dft_matmul(x, w), dft_matmul_plain(x, w))
    elif kernel == "unpack_dft":
        packed = _cx(rng, (2 * nb, npm), dev)
        packed[:nb, spheres[0].npacked:] = float("nan")   # never read
        packed[nb:, spheres[1].npacked:] = float("nan")
        _, _, w = dft_matrix_device(16, 8, True, dev)
        got = sp.unpack_dft(packed, *tabs, w)
        _close(got, sp.unpack_dft_plain(packed, *tabs, w))
        flag0 = tabs[3].clone()
        flag0[2] = 0
        y0 = torch.view_as_real(sp.unpack_dft(packed, *tabs[:3], flag0,
                                              w)[:, 2])
        assert bool(((y0 == 0) & ~torch.signbit(y0)).all())
    else:
        slab = _cx(rng, (2 * nb, 8, 8, 16), dev)
        nvalid = torch.as_tensor(np.repeat(np.asarray(
            [s.npacked for s in spheres], np.int32), nb), device=dev)
        _, _, w = dft_matrix_device(8, 16, False, dev)
        got = sp.dft_pack(slab, *tabs[:3], nvalid, w, npm)
        _close(got, sp.dft_pack_plain(slab, *tabs[:3], nvalid, w, npm))
        pad = torch.arange(npm, device=dev)[None] >= nvalid[:, None]
        pz = torch.view_as_real(got[pad])
        assert pad.any() and bool(((pz == 0) & ~torch.signbit(pz)).all())
    # one launch per wrapper call on a CUDA tensor (unpack_dft: two calls)
    assert fn.launches == before + (2 if kernel == "unpack_dft" else 1)


@pytest.mark.cuda
def test_scf_on_cuda_launches_every_kernel_and_matches_cpu(cuda_device):
    wrappers = (dft_matmul, sp.unpack_dft, sp.dft_pack)
    before = [f.launches for f in wrappers]
    cfg = SCFConfig(n=16, nbands=4, kpts=KPTS2, max_iter=3, stack_k=True,
                    backend="cuda")
    gpu = run_scf(cfg)                       # the default device is CUDA
    assert gpu.device.startswith("cuda")
    assert all(f.launches > n for f, n in zip(wrappers, before))
    cpu = run_scf(cfg, device="cpu")
    np.testing.assert_allclose(gpu.energies, cpu.energies, rtol=0,
                               atol=3e-5)
