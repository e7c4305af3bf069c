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

The top level binds every name that ``projected_lmc_tpu`` binds, from the
port's own modules (``ABSENT_BY_DESIGN`` lists the exceptions), so that
``import projected_lmc_tpu_torch as pl`` offers ``pl.MaternKernel``,
``pl.safe_cholesky``, ``pl.LMCMixingMatrix`` and the rest. Importing it
builds no kernel and loads neither JAX, pandas nor matplotlib.

Absent by design (``ABSENT_BY_DESIGN``, each with its reason):

  * ``Module``, ``trainable_mask``, ``partition``, ``combine``,
    ``Module.replace``, ``Module.astype``: JAX's functional module API. A
    ``torch.nn.Module`` holds its parameters and is updated in place;
    ``module.trainable_parameters`` gives what the optimizer updates and
    ``.to(dtype)`` casts.
  * ``utils.ensure_tpu``: its counterpart is ``utils.ensure_cuda``.
  * ``ops.pallas_kernels``: its counterpart is ``ops.cuda_kernels``.
  * ``ops.fused_mll.SYM_BUILD``: the port reads ``PLMC_SYM_BUILD`` at each
    call.
  * ``ops.iterative.draw_probes(key=)``,
    ``ops.iterative.residual_spectral_bound(seed=)`` and
    ``ops.iterative.icm_residual_spectral_bound(seed=)``: the port takes a
    ``torch.Generator`` or an explicit start vector (``v0=``).
  * ``kernels.stationary_kernel_matrix(use_pallas=)``,
    ``kernels.RBFKernel(use_pallas=)`` and
    ``kernels.MaternKernel(use_pallas=)``: the route follows the tensors'
    device (K3 on CUDA tensors, the plain version on the CPU).
"""

__version__ = "0.1.0"

from . import constraints
from .distributions import (BatchIndepCov, DenseCov, KronCov,
                            MultitaskMultivariateNormal, MultivariateNormal,
                            SumKronRank1Cov)
from .kernels import (AdditiveKernel, Kernel, MaternKernel, RBFKernel,
                      ScaleKernel, SpectralMixtureKernel, SplineKernel,
                      handle_covar)
from .likelihoods import (FixedTaskNoise, GaussianLikelihood,
                          MultitaskGaussianLikelihood)
from .means import ConstantMean, LinearMean, PolynomialMean, ZeroMean
from .metrics import compute_metrics
from .mlls import exact_mll, loo_pseudo_likelihood, projected_lmc_mll
from .models.exact import ExactGPModel
from .models.multitask import MultitaskGPModel
from .models.projected import LMCMixingMatrix, ProjectedGPModel
from .models.variational import VariationalMultitaskGPModel
from .ops import init_lmc_coefficients, latin_hypercube, safe_cholesky, sobol
from .training import (default_scan_steps, exponential_schedule, fit,
                       fit_ensemble, fit_svgp_minibatch, fit_two_phase,
                       lambda_lr_schedule)
from .utils.checkpoint import (load_jax_state, load_model, load_orbax,
                               save_model, save_orbax)
from . import parallel

# reference-compatible aliases (projected_lmc.py:107, :1158)
handle_covar_ = handle_covar
ProjectedLMCmll = projected_lmc_mll
LeaveOneOutPseudoLikelihood = loo_pseudo_likelihood

_MODULE_API = ("JAX's functional module API: a torch.nn.Module holds its "
               "parameters and is updated in place")
_ROUTE = "the route follows the tensors' device"
ABSENT_BY_DESIGN = (
    ("Module", _MODULE_API),
    ("trainable_mask", _MODULE_API),
    ("partition", _MODULE_API),
    ("combine", _MODULE_API),
    ("Module.replace", _MODULE_API),
    ("Module.astype", _MODULE_API + "; .to(dtype) casts"),
    ("utils.ensure_tpu", "its counterpart is utils.ensure_cuda"),
    ("ops.pallas_kernels", "its counterpart is ops.cuda_kernels"),
    ("ops.fused_mll.SYM_BUILD", "PLMC_SYM_BUILD is read at each call"),
    ("ops.iterative.draw_probes(key=)", "probes come from a torch.Generator"),
    ("ops.iterative.residual_spectral_bound(seed=)",
     "an explicit start vector, v0="),
    ("ops.iterative.icm_residual_spectral_bound(seed=)",
     "an explicit start vector, v0="),
    ("kernels.stationary_kernel_matrix(use_pallas=)", _ROUTE),
    ("kernels.RBFKernel(use_pallas=)", _ROUTE),
    ("kernels.MaternKernel(use_pallas=)", _ROUTE),
)

__all__ = ["ABSENT_BY_DESIGN", "AdditiveKernel", "BatchIndepCov",
           "ConstantMean", "DenseCov", "ExactGPModel", "FixedTaskNoise",
           "GaussianLikelihood", "Kernel", "KronCov",
           "LMCMixingMatrix", "LeaveOneOutPseudoLikelihood", "LinearMean",
           "MaternKernel", "MultitaskGaussianLikelihood", "MultitaskGPModel",
           "MultitaskMultivariateNormal", "MultivariateNormal",
           "PolynomialMean", "ProjectedGPModel", "ProjectedLMCmll",
           "RBFKernel", "ScaleKernel", "SpectralMixtureKernel",
           "SplineKernel", "SumKronRank1Cov", "VariationalMultitaskGPModel",
           "ZeroMean", "__version__", "compute_metrics", "constraints",
           "default_scan_steps", "exact_mll", "exponential_schedule", "fit",
           "fit_ensemble", "fit_svgp_minibatch", "fit_two_phase",
           "handle_covar", "handle_covar_", "init_lmc_coefficients",
           "lambda_lr_schedule", "latin_hypercube", "load_jax_state",
           "load_model", "load_orbax", "loo_pseudo_likelihood", "parallel",
           "projected_lmc_mll", "safe_cholesky", "save_model", "save_orbax",
           "sobol"]
