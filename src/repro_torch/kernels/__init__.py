"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain PyTorch
versions, all on one tensor-core GEMM in split TF32: the complex line-DFT
GEMM (``dft_matmul``) and the fused sphere-pack kernels
(``sphere_pack.unpack_dft`` / ``sphere_pack.dft_pack``).
Sources live in ``csrc/`` and are built at first use (``build``)."""
