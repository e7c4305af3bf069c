"""Models of the port: the exact GP, the exact LMC/ICM multitask GP, the
projected LMC and the variational LMC."""

from .exact import ExactGPModel
from .multitask import MultitaskGPModel
from .projected import ProjectedGPModel
from .variational import VariationalMultitaskGPModel

__all__ = ["ExactGPModel", "MultitaskGPModel", "ProjectedGPModel",
           "VariationalMultitaskGPModel"]
