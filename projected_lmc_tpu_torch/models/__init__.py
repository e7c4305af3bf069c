"""Models of the port: the exact GP and the exact LMC multitask GP."""

from .exact import ExactGPModel
from .multitask import MultitaskGPModel

__all__ = ["ExactGPModel", "MultitaskGPModel"]
