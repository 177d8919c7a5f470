"""Kernel #1's factored mode on the CPU: its plain version (the kernel's
two 16-point stages and twiddle in plain PyTorch) against the "fft"
backend on rows and on strided planes, the shape rule that chooses it, the
operand embedding in the kernel's k8 column order, and the ``fftb``
probe's count of line stages by mode.  The kernel itself is held against
this plain version on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import local_fft
from repro_torch.kernels import ops
from repro_torch.kernels.dft_matmul import (_embed_k8, dft_factored,
                                            dft_factored_cols,
                                            dft_factored_cols_plain,
                                            dft_factored_plain,
                                            factored_operands,
                                            factored_split, tf32_split)
from repro_torch.obs.metrics import global_metrics

RTOL = 1e-6

# (n_in, n_out, inverse): the paper pair's and gw-mtxel's stage shapes
# and the square line both ways
SHAPES = [(128, 256, True), (256, 128, False), (256, 64, False),
          (256, 256, True), (256, 256, False)]


def _cx(rng, shape):
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)
                            ).astype(np.complex64))


def _close(got, want, rtol=RTOL):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.mark.parametrize("layout", ["rows", "strided"])
@pytest.mark.parametrize("n_in,n_out,inverse", SHAPES)
def test_factored_plain_matches_fft_backend(n_in, n_out, inverse, layout):
    rng = np.random.default_rng(n_in * 7 + n_out + inverse)
    fo = factored_operands(n_out, n_in, inverse, "cpu")
    if layout == "rows":
        x = _cx(rng, (96, n_in))
        got = dft_factored_plain(x, fo)
        lines = x
    else:
        x = _cx(rng, (3, n_in, 32))          # (P, K, L): lines over L
        got = dft_factored_cols_plain(x, fo)
        lines = x.transpose(1, 2).reshape(-1, n_in)
    want = local_fft.local_dft(lines, 1, n_out, inverse=inverse,
                               backend="fft")
    assert got.shape == want.shape and got.dtype == torch.complex64
    _close(got, want)


@pytest.mark.parametrize("n_in,n_out,split", [
    (128, 256, (16, 16)), (256, 128, (16, 16)), (256, 64, (16, 16)),
    (256, 256, (16, 16)), (64, 256, (16, 16)), (256, 32, None),
    (32, 256, None), (192, 256, None), (128, 128, None), (64, 64, None),
    (512, 256, None), (16, 8, None), (24, 40, None)])
def test_factored_split_chooses_by_shape(n_in, n_out, split):
    """The factored mode takes lines whose longer length is 256 and whose
    lengths are whole k8 steps of both stages (64, 128, 256); every other
    shape keeps the dense product."""
    assert factored_split(n_in, n_out) == split


@pytest.mark.parametrize("n_in,n_out,inverse", SHAPES)
def test_dft_apply_takes_the_factored_plain_version_on_cpu(n_in, n_out,
                                                           inverse):
    rng = np.random.default_rng(n_in + n_out)
    x = _cx(rng, (40, n_in))
    fo = ops.factored_operands_device(n_out, n_in, inverse,
                                      torch.device("cpu"))
    got = ops.dft_apply(x, n_out, inverse=inverse)
    assert torch.equal(got, dft_factored_plain(x, fo))
    assert torch.equal(dft_factored(x, fo), got)
    planes = _cx(rng, (2, n_in, 8))
    assert torch.equal(dft_factored_cols(planes, fo),
                       dft_factored_cols_plain(planes, fo))


@pytest.mark.parametrize("n_in,n_out,inverse", SHAPES)
def test_factored_operators_are_the_dense_operator(n_in, n_out, inverse):
    """The two stages and twiddle, applied to the identity, give
    ``dft_matrix(n_out, n_in)``: the same operator, rows in natural
    order, the inverse scaled by 1/n once."""
    fo = factored_operands(n_out, n_in, inverse, "cpu")
    eye = torch.eye(n_in, dtype=torch.complex64)
    got = dft_factored_plain(eye, fo).T
    want = torch.as_tensor(local_fft.dft_matrix(n_out, n_in, inverse))
    _close(got, want, 2e-6)


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("n_in,n_out,inverse", SHAPES)
def test_k8_embedding_is_the_complex_product(n_in, n_out, inverse, stage):
    """A row laid out as the kernel's A fragment reads it (complex column
    k, part e at 8·(k // 4) + k % 4 + 4·e) times the split embedding's
    transpose is the complex product with the stage's DFT matrix."""
    fo = factored_operands(n_out, n_in, inverse, "cpu")
    w = (fo.f1, fo.f2)[stage]
    N, K = w.shape
    x = _cx(np.random.default_rng(K + N), (20, K))
    k = torch.arange(K)
    pos = 8 * (k // 4) + k % 4
    a = torch.zeros((20, 2 * K), dtype=torch.float64)
    a[:, pos], a[:, pos + 4] = x.real.double(), x.imag.double()
    big, small = tf32_split(_embed_k8(w))
    y = a @ (big.double() + small.double()).T
    want = x.to(torch.complex128) @ w.to(torch.complex128).T
    _close(torch.complex(y[:, 0::2], y[:, 1::2]), want, 1e-6)


@pytest.mark.parametrize("n_in,n_out,mode", [(128, 256, "factored"),
                                             (256, 64, "factored"),
                                             (32, 64, "dense")])
def test_fftb_probe_counts_line_dfts_by_mode(n_in, n_out, mode):
    """One "cuda" line stage counts once in ``line_dfts_<mode>`` of the
    ``fftb`` probe, next to its ``line_reads_*``."""
    x = _cx(np.random.default_rng(3), (2, n_in, 4))
    before = dict(global_metrics().snapshot()["fftb"])
    y = local_fft.local_dft(x, 1, n_out, inverse=True, backend="cuda")
    after = global_metrics().snapshot()["fftb"]
    assert y.shape == (2, n_out, 4)
    delta = {k: after[k] - before[k]
             for k in ("line_dfts_factored", "line_dfts_dense")}
    assert delta == {"line_dfts_factored": int(mode == "factored"),
                     "line_dfts_dense": int(mode == "dense")}
    _close(y, local_fft.local_dft(x, 1, n_out, inverse=True,
                                  backend="fft"))
