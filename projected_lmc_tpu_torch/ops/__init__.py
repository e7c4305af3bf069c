"""Numerical operators of the port: the CUDA kernels and their plain
versions, Cholesky, the iterative exact-LMC pieces and the fused MLL.

Re-exports what ``projected_lmc_tpu.ops`` does: the Cholesky helpers, the
initializers, and the ``kron`` and ``woodbury`` modules. Importing it builds
and loads nothing (``_build`` compiles the kernels on their first call)."""

from .cholesky import (add_jitter, cho_solve, chol_inverse_diag,
                       logdet_from_chol, safe_cholesky,
                       safe_cholesky_with_jitter, solve_triangular,
                       symmetrize)
from .init_ops import (init_lmc_coefficients, latin_hypercube, randomized_svd,
                       sobol)
from . import kron
from . import woodbury

__all__ = ["add_jitter", "cho_solve", "chol_inverse_diag",
           "init_lmc_coefficients", "kron", "latin_hypercube",
           "logdet_from_chol", "randomized_svd", "safe_cholesky",
           "safe_cholesky_with_jitter", "sobol", "solve_triangular",
           "symmetrize", "woodbury"]
