"""clip_codec_tpu_torch — the PyTorch + CUDA port of ``clip_codec_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names
and holds its decompress paths: ``.clp`` frames (``io``) -> dequantized,
L2-normalized CLIP codes (``codecs``) -> DDIM (``diffusion``) over the
FiLM U-Net (``models``), or CFG sampling through the SD-1.5 UNet and VAE
(``models.sd``); and the SD adapter's training (``train``,
``cli.precompute_latents``, ``cli.train_sd``). Their hot paths run in
hand-written CUDA kernels (``ops``, ``csrc/``). It imports ``torch`` and
never ``jax``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy exports, so ``--help`` paths import nothing heavy."""
    if name == "ClipCodec":
        from .codec import ClipCodec

        return ClipCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
