"""repro_torch.core.spectral against the reference ``repro.core.spectral``.

``fft_conv`` (1D and 2D kernels, K ≤ S, sequence axis 1) and
``fourier_mixer`` on the port's "fft", "matmul" and "cuda" backends (the
last runs the line-DFT kernel's plain version on the CPU) agree with the
reference's "jnp" and "matmul" routes within 1e-6 of the largest output.
Under a bf16 policy both packages round the same real inputs to bf16
before the complex promotion, so the port's bf16 result is held to the
reference's own bf16 result at the same 1e-6 (the transforms are f32 on
both sides; only the summation order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.spectral as RS
from repro.core.policy import ExecPolicy as RefPolicy
import repro_torch.core as T
from repro_torch.core.policy import ExecPolicy

RTOL = 1e-6          # relative to the largest output magnitude
BF16_RTOL = 1e-6     # the same: both sides transform identical bf16 inputs
# the port's backend names against the reference's
ROUTES = [("fft", "jnp"), ("matmul", "matmul"), ("cuda", "matmul")]


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _inputs(shape, K, kernel_2d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kshape = (K, shape[-1]) if kernel_2d else (K,)
    return x, rng.standard_normal(kshape).astype(np.float32)


@pytest.mark.parametrize("backend,ref_backend", ROUTES)
@pytest.mark.parametrize("shape,K,kernel_2d", [
    ((2, 24, 5), 4, True),         # Mamba-style depthwise (K, C) kernel
    ((2, 24, 5), 24, True),        # K = S: the longest causal kernel
    ((3, 17, 4), 5, False),        # one (K,) kernel for every channel
    ((1, 9, 3, 2), 3, False),      # an extra trailing dim
])
def test_fft_conv_matches_reference(backend, ref_backend, shape, K,
                                    kernel_2d):
    x, k = _inputs(shape, K, kernel_2d)
    got = T.fft_conv(torch.as_tensor(x), torch.as_tensor(k), axis=1,
                     backend=backend)
    want = RS.fft_conv(jnp.asarray(x), jnp.asarray(k), axis=1,
                       backend=ref_backend)
    _close(got, want)


def test_fft_conv_is_the_causal_convolution():
    x, k = _inputs((2, 16, 3), 4, True, seed=1)
    got = T.fft_conv(torch.as_tensor(x), torch.as_tensor(k)).numpy()
    want = np.zeros_like(x)
    for t in range(16):
        for j in range(min(4, t + 1)):
            want[:, t] += k[j] * x[:, t - j]
    _close(got, want)


@pytest.mark.parametrize("backend,ref_backend", ROUTES)
@pytest.mark.parametrize("shape", [(2, 16, 8), (1, 12, 10)])
def test_fourier_mixer_matches_reference(backend, ref_backend, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = T.fourier_mixer(torch.as_tensor(x), backend=backend)
    want = RS.fourier_mixer(jnp.asarray(x), backend=ref_backend)
    _close(got, want)
    _close(got, np.fft.fft2(x.astype(np.float64), axes=(1, 2)).real
           .astype(np.float32))


@pytest.mark.parametrize("backend,ref_backend", ROUTES)
def test_bf16_policy_matches_reference_bf16(backend, ref_backend):
    x, k = _inputs((2, 20, 6), 4, True, seed=3)
    pol, rpol = ExecPolicy(compute_dtype="bfloat16"), \
        RefPolicy(compute_dtype="bfloat16")
    got = T.fft_conv(torch.as_tensor(x), torch.as_tensor(k),
                     backend=backend, policy=pol)
    want = RS.fft_conv(jnp.asarray(x), jnp.asarray(k), backend=ref_backend,
                       policy=rpol)
    _close(got, want, BF16_RTOL)
    got = T.fourier_mixer(torch.as_tensor(x), backend=backend, policy=pol)
    want = RS.fourier_mixer(jnp.asarray(x), backend=ref_backend,
                            policy=rpol)
    _close(got, want, BF16_RTOL)
    # and the bf16 rounding is really applied: f32 inputs differ
    f32 = T.fourier_mixer(torch.as_tensor(x), backend=backend)
    assert float((f32 - got).abs().max()) > 10 * BF16_RTOL * float(
        f32.abs().max())


def test_shape_checks_follow_the_policy():
    x = torch.zeros((2, 8, 3))
    with pytest.raises(ValueError, match="channels"):
        T.fft_conv(x, torch.zeros((2, 4)), policy=ExecPolicy())
    with pytest.raises(ValueError, match=r"\(K,\) or \(K, C\)"):
        T.fft_conv(x, torch.zeros((2, 3, 1)), policy=ExecPolicy())
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        T.fourier_mixer(torch.zeros((8, 3)), policy=ExecPolicy())
    assert T.fourier_mixer(torch.zeros((8, 3))).shape == (8, 3)
