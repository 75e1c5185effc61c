"""Kernels and numerics: fused flash forward, decode, paged, quantization."""

from .decode import decode_attention  # noqa: F401
from .flash import flash_attention  # noqa: F401
from .paged import paged_decode_attention  # noqa: F401
from .quant import (  # noqa: F401
    dequantize,
    dynamically_quantize_fp8,
    dynamically_quantize_int8,
    quantize_channel_wise,
    quantize_head_wise,
    quantize_token_wise,
)
from .sdpa import sdpa_reference  # noqa: F401
