from .quantizer import dequantize_l2norm, dequantize_l2norm_host

__all__ = ["dequantize_l2norm", "dequantize_l2norm_host"]
