from .blocks import AttnBlock, DWConvBlock, FiLM, ResBlock
from .decoders import CLIPCondDecoder, FeatureToImageDecoderLite
from .unet import CLIPCondUNet, init_params, timestep_embedding

__all__ = ["AttnBlock", "CLIPCondDecoder", "CLIPCondUNet", "DWConvBlock", "FeatureToImageDecoderLite", "FiLM",
           "ResBlock", "init_params", "timestep_embedding"]
