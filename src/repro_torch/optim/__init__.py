"""Optimizers of the PyTorch port."""

from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm
from .compress import compress_grads, dequantize_int8, int8_codec_roundtrip, quantize_int8

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm",
           "compress_grads", "dequantize_int8", "int8_codec_roundtrip", "quantize_int8"]
