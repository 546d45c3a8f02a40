from .checkpoint import load_state_dict
from .config import ModelConfig

__all__ = ["ModelConfig", "load_state_dict"]
