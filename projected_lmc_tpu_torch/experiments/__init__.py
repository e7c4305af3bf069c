"""Experiment helpers of the port (so far the synthetic data generator)."""

from .synthetic import generate_synthetic

__all__ = ["generate_synthetic"]
