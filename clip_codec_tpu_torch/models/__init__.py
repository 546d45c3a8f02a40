from .blocks import FiLM, ResBlock
from .unet import CLIPCondUNet, init_params, timestep_embedding

__all__ = ["CLIPCondUNet", "FiLM", "ResBlock", "init_params", "timestep_embedding"]
