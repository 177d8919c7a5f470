"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain PyTorch
versions: the complex line-DFT GEMM (``dft_matmul``, on the tensor cores
in split TF32) and the fused sphere-pack kernels
(``sphere_pack.unpack_dft`` / ``sphere_pack.dft_pack``, SIMT fp32).
Sources live in ``csrc/`` and are built at first use (``build``)."""
