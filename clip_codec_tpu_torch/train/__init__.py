"""Training loops of the port (``sd_diffusion_train``: the SD-1.5 CLIP adapter)."""
