"""quantumattention_tpu — FP8 attention engine in JAX.

A JAX/XLA/Pallas re-design with the full capability surface of the
reference WaveSpeedAI/QuantumAttention (CUDA/torch, Hopper-only): dynamic FP8
(and int8) dual-granularity quantization, fused flash-attention kernels,
graceful SDPA fallback, and a config/flag system — extended with GQA fast
paths, sliding windows, paged FP8 KV-cache decode, and mesh parallelism
(head-sharded TP + ring sequence parallelism), which the reference lacks.

Public surface mirrors the reference package root
(reference: src/quantum_attn/__init__.py:10-31).
"""

from . import config  # noqa: F401
from .dispatch import can_use_attention  # noqa: F401
from .interface import (  # noqa: F401
    attn_func,
    attn_func_with_fallback,
    fp8_attn_func,
    fp8_attn_func_with_fallback,
    fp8_token_wise_attn_func,
    fp8_token_wise_attn_func_with_fallback,
)
from .ops.quant import (  # noqa: F401
    dynamically_quantize_fp8,
    dynamically_quantize_int8,
)

__version__ = "0.1.0"

__all__ = [
    "attn_func",
    "attn_func_with_fallback",
    "fp8_attn_func",
    "fp8_attn_func_with_fallback",
    "fp8_token_wise_attn_func",
    "fp8_token_wise_attn_func_with_fallback",
    "dynamically_quantize_fp8",
    "dynamically_quantize_int8",
    "can_use_attention",
    "config",
]
