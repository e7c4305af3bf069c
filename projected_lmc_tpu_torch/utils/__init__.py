"""Device resolution, checkpoints (with the JAX-state carrier) and the
profiling helpers. ``ensure_cuda`` is the counterpart of the JAX package's
``ensure_tpu``."""

from .checkpoint import load_model, save_model
from .device import ensure_cuda
from .profiling import Timer, profile_trace

__all__ = ["Timer", "ensure_cuda", "load_model", "profile_trace",
           "save_model"]
