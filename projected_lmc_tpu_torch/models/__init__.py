"""Models of the port: the exact GP, the exact LMC/ICM multitask GP, the
projected LMC with its mixing matrix, and the variational LMC."""

from .exact import ExactGPModel
from .multitask import MultitaskGPModel
from .projected import LMCMixingMatrix, ProjectedGPModel
from .variational import VariationalMultitaskGPModel

__all__ = ["ExactGPModel", "LMCMixingMatrix", "MultitaskGPModel",
           "ProjectedGPModel", "VariationalMultitaskGPModel"]
