"""clip_codec_tpu_torch — the PyTorch + CUDA port of ``clip_codec_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names
and holds its compress side: images -> CLIP ViT-B/32 embeddings
(``encoders``) -> uint8 codes (``codecs``) -> ``.clp`` frames and a store
(``io``, ``cli.encode_images``); its decompress paths: frames ->
dequantized, L2-normalized codes -> DDIM (``diffusion``) over the FiLM
U-Net (``models``), or CFG sampling through the SD-1.5 UNet and VAE
(``models.sd``); and the two decoders' training (``train``,
``cli.precompute_latents``, ``cli.train_sd``, ``cli.train``). The
decoders' hot paths run in hand-written CUDA kernels (``ops``, ``csrc/``).
It imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy exports, so ``--help`` paths import nothing heavy."""
    if name == "ClipCodec":
        from .codec import ClipCodec

        return ClipCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
