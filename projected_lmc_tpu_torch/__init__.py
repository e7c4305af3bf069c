"""PyTorch/CUDA port of ``projected_lmc_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports neither
JAX nor ``projected_lmc_tpu``. It ports the exact-LMC training step
(``models.multitask.MultitaskGPModel`` with the fused iterative MLL, and
``training.fit``), the batched exact GP (``models.exact.ExactGPModel``,
dense or fused iterative MLL, ``mlls.exact_mll``), the exact ICM
(``MultitaskGPModel(model_type="ICM")``: the Kronecker MLL with its
analytic backward, or the matrix-free PCG estimator above n = 8192, and its
posteriors and ``compute_var``), the int8 stack
(``matvec_int8``) and ``training.fit_two_phase``, and the paper's projected
LMC (``models.projected.ProjectedGPModel`` trained on
``mlls.projected_lmc_mll``), and prediction with all of them: the exact,
LMC, ICM and projected-LMC posteriors, LOO (``mlls.loo_pseudo_likelihood``) and
``metrics.compute_metrics``, and the variational and SGPR models: the SVGP
``models.variational.VariationalMultitaskGPModel`` (its ELBO, the
closed-form SGPR E/M steps, ``training.fit_svgp_minibatch``) and the
Titsias SGPR route of the exact, LMC/ICM and projected models
(``n_inducing_points``), and the rest of the model surface: additive
(``decomp``), spline and spectral-mixture kernels, linear and polynomial
means with the universal-kriging LOO, the composed and CG + SLQ MLL routes
(``ops.iterative``), the blocked bf16 Cholesky, ``fit``'s chunks,
checkpoints and evals, and ``save_model``/``load_model`` (checkpoints
interchangeable with the JAX package's), and the experiments around them:
the study driver (``experiments.run_study``, ``build_models``,
``train_and_eval``), the real-data loaders (``experiments.realdata``, no
pandas needed), the study plots (``experiments.plots``, pandas and
matplotlib, on the host), seed-parallel training
(``training.fit_ensemble``), per-batch 3-D kernel inputs and the profiling
helpers (``utils.profiling``, ``utils.device.ensure_cuda``); with a
hand-written CUDA kernel for each TPU kernel of the JAX package
(``ops/cuda_kernels.py``, sources in ``csrc/``). Entry points default to
``device="cuda"``; ``device="cpu"`` runs the kernels' plain PyTorch versions.

Multi-rank execution (``parallel``): the ('data', 'latent') mesh on
``torch.distributed``, one process a rank, sharded training and prediction
of the projected LMC (exact and SGPR) and of the variational ELBO
(``parallel.shard_model``, ``parallel.sharded_fit_step``), checkpoints on
``torch.distributed.checkpoint`` (``utils.checkpoint.save_orbax``) and
``entry.dryrun_multichip``.
"""

from .distributions import KronCov, SumKronRank1Cov
from .likelihoods import GaussianLikelihood, MultitaskGaussianLikelihood
from .metrics import compute_metrics
from .mlls import exact_mll, loo_pseudo_likelihood, projected_lmc_mll
from .models.exact import ExactGPModel
from .models.multitask import MultitaskGPModel
from .models.projected import ProjectedGPModel
from .models.variational import VariationalMultitaskGPModel
from .training import (default_scan_steps, exponential_schedule, fit,
                       fit_ensemble, fit_svgp_minibatch, fit_two_phase,
                       lambda_lr_schedule)
from .utils.checkpoint import (load_jax_state, load_model, load_orbax,
                               save_model, save_orbax)
from . import parallel

__all__ = ["ExactGPModel", "GaussianLikelihood", "KronCov",
           "MultitaskGaussianLikelihood", "MultitaskGPModel",
           "ProjectedGPModel", "SumKronRank1Cov",
           "VariationalMultitaskGPModel", "compute_metrics",
           "default_scan_steps", "exact_mll", "exponential_schedule", "fit",
           "fit_ensemble", "fit_svgp_minibatch", "fit_two_phase", "lambda_lr_schedule",
           "load_jax_state", "load_model", "load_orbax",
           "loo_pseudo_likelihood", "parallel", "projected_lmc_mll",
           "save_model", "save_orbax"]
