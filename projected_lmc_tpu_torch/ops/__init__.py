"""Numerical operators of the port: the CUDA kernels and their plain
versions, Cholesky, the iterative exact-LMC pieces and the fused MLL."""
