"""Models of the port: the exact GP, the exact LMC multitask GP and the
projected LMC."""

from .exact import ExactGPModel
from .multitask import MultitaskGPModel
from .projected import ProjectedGPModel

__all__ = ["ExactGPModel", "MultitaskGPModel", "ProjectedGPModel"]
