from .model import Model, build_model
from .transformer import ModelOptions

__all__ = ["Model", "ModelOptions", "build_model"]
