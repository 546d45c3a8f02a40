"""Training loops of the port (``diffusion_train``: the pixel decoder; ``sd_diffusion_train``: the SD-1.5
CLIP adapter)."""
