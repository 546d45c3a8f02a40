from .decoder import (
    SD_SCALING_FACTOR,
    SDClipAdapter,
    SDSchedulerTables,
    StableDiffusionDecoder,
    sd_alphas_cumprod,
    sd_ddim_timesteps,
)
from .unet import SD15_UNET, SDUNet, SDUNetConfig, sd_timestep_embedding
from .vae import SD15_VAE, AutoencoderKL, VAEConfig

__all__ = [
    "SDClipAdapter", "StableDiffusionDecoder", "SDSchedulerTables",
    "SD_SCALING_FACTOR", "sd_alphas_cumprod", "sd_ddim_timesteps",
    "SDUNet", "SDUNetConfig", "SD15_UNET", "sd_timestep_embedding",
    "AutoencoderKL", "VAEConfig", "SD15_VAE",
]
