"""The experiment harness of the port: the synthetic data generator, the
parametric-study driver, the real-data loaders and the study plots."""

from .driver import DEFAULT_PARAMS, DEFAULT_SWEEPS, build_models, run_study
from .synthetic import generate_synthetic

__all__ = ["DEFAULT_PARAMS", "DEFAULT_SWEEPS", "build_models",
           "generate_synthetic", "run_study"]
