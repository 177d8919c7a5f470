"""repro_torch — the PyTorch/CUDA port of the FFTB plane-wave package.

Same sub-package layout as the JAX reference ``repro`` (``core/``,
``kernels/``, ``dft/``), one module per reference module.  Entry points run
on CUDA unless the caller passes ``device="cpu"``; without a CUDA device
and without an explicit ``device`` they raise.  The package imports torch
and numpy only.
"""
