"""mamba2-370m — attention-free SSD (state-space duality) [arXiv:2405.21060].

The depthwise temporal conv can run through FFTB (`conv_impl="fft"`) — the
paper-technique integration point for this family; in the port it runs
through ``repro_torch.core.spectral.fft_conv``.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
    conv_kernel=4, conv_impl="direct",
    source="arXiv:2405.21060; unverified",
))
