"""Model plane of the PyTorch port."""

from .api import Model, build_model
from .config import ModelConfig

__all__ = ["Model", "ModelConfig", "build_model"]
