from .quantizer import (
    PerChannelAffineQuantizer,
    dequantize,
    dequantize_l2norm,
    dequantize_l2norm_host,
    fit_affine,
    quantize,
)

__all__ = ["PerChannelAffineQuantizer", "fit_affine", "quantize", "dequantize", "dequantize_l2norm",
           "dequantize_l2norm_host"]
