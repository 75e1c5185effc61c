"""Dynamic quantization for attention operands.

The quantization math is the capability spec from the reference
(src/quantum_attn/nn.py:14-19):

    scale = clamp(amax(|t|, dims) / FP8_MAX, eps)
    t_q   = cast(clamp(t / scale, -FP8_MAX, FP8_MAX), float8_e4m3fn)
    return t_q, squeeze(scale, dims).astype(float32)

Granularities (reference nn.py:410-418):
  * head-wise:  reduce over [-2, -1]  -> scale shape (B, H)
  * token-wise: reduce over [-1]      -> scale shape (B, H, S)

This module adds an int8 variant with identical structure (the KV-cache and
weight container); fp8 e4m3 is the attention container, fed to the fp8
tensor cores on Hopper.  Everything is pure jnp so XLA fuses the quantization into
surrounding computation (the analogue of the reference compiling the
quantizer with Inductor, nn.py:22-42).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp

#: Max representable magnitude of float8_e4m3fn (reference nn.py:15 uses 448).
FP8_E4M3_MAX = 448.0
INT8_MAX = 127.0

#: Scale clamp floor; the reference clamps scales to fp32 eps (nn.py:16).
SCALE_EPS = float(jnp.finfo(jnp.float32).eps)

_Dims = Union[int, Sequence[int]]


def _normalize_dims(reduction_dim: _Dims) -> Tuple[int, ...]:
    if isinstance(reduction_dim, int):
        return (reduction_dim,)
    return tuple(reduction_dim)


def _dynamic_quantize(
    t: jax.Array, reduction_dim: _Dims, qmax: float, qdtype
) -> Tuple[jax.Array, jax.Array]:
    dims = _normalize_dims(reduction_dim)
    amax = jnp.max(jnp.abs(t.astype(jnp.float32)), axis=dims, keepdims=True)
    scale = jnp.maximum(amax / qmax, SCALE_EPS)
    t_scaled = jnp.clip(t.astype(jnp.float32) / scale, -qmax, qmax)
    if jnp.issubdtype(qdtype, jnp.integer):
        t_scaled = jnp.round(t_scaled)
    t_q = t_scaled.astype(qdtype)
    return t_q, jnp.squeeze(scale, axis=dims).astype(jnp.float32)


def dynamically_quantize_fp8(
    t: jax.Array, *, reduction_dim: _Dims = -1
) -> Tuple[jax.Array, jax.Array]:
    """Quantize to float8_e4m3fn with dynamic scales.

    Public API parity with the reference's ``dynamically_quantize_fp8``
    (nn.py:22-42 / __init__.py:13).
    """
    return _dynamic_quantize(t, reduction_dim, FP8_E4M3_MAX, jnp.float8_e4m3fn)


def dynamically_quantize_int8(
    t: jax.Array, *, reduction_dim: _Dims = -1
) -> Tuple[jax.Array, jax.Array]:
    """Quantize to int8 with dynamic scales."""
    return _dynamic_quantize(t, reduction_dim, INT8_MAX, jnp.int8)


def dynamically_quantize_int4(
    t: jax.Array, *, reduction_dim: _Dims = -1
) -> Tuple[jax.Array, jax.Array]:
    """Quantize to int4 (packed two-per-int8 byte) with dynamic scales.

    Beyond the reference (which stops at 8-bit — nn.py:22-42): decode is
    DMA-bound at the HBM roof (CLAUDE.md measured truths), so the only
    remaining throughput lever is fewer bytes; int4 halves the KV stream
    again at ~2x the int8 rounding error.

    Packing puts element d in the LOW nibble and element d + D/2 in the
    HIGH nibble of packed byte d (a split-halves layout, not pairwise):
    the kernel unpacks with two arithmetic shifts and a minor-dim concat
    that lands elements in [0..D/2) ++ [D/2..D) order — no interleave
    relayout.  ``reduction_dim`` must be the last axis, and that axis must
    be even.

    Returns (packed int8 array with last dim D/2, fp32 scales like int8).
    """
    dims = _normalize_dims(reduction_dim)
    if dims != (-1,) and dims != (t.ndim - 1,):
        raise ValueError("int4 packing requires reduction_dim == -1")
    q, scale = quantize_int4_values(t, reduction_dim=reduction_dim)
    return pack_int4(q), scale


def quantize_int4_values(
    t: jax.Array, *, reduction_dim: _Dims = -1
) -> Tuple[jax.Array, jax.Array]:
    """Int4 quantization WITHOUT packing: values in [-7, 7] carried in an
    int8 container, plus fp32 scales.  The building block for containers
    that pack along an axis other than the reduction axis (e.g. paged KV
    pages pack two TOKENS per byte so the 128-lane head_dim minor survives
    for DMA alignment — serving/paged_cache.py)."""
    return _dynamic_quantize(t, _normalize_dims(reduction_dim), 7.0, jnp.int8)


def pack_int4(values: jax.Array, axis: int = -1) -> jax.Array:
    """Pack int4-range values (int8 container) two-per-byte along ``axis``
    with the split-halves layout: element i -> LOW nibble, element
    i + n/2 -> HIGH nibble of packed byte i.  ``axis``'s extent must be
    even.  Inverse: :func:`unpack_int4` with the same axis."""
    axis = axis % values.ndim
    n = values.shape[axis]
    if n % 2 != 0:
        raise ValueError(f"axis {axis} must be even to pack int4, got {n}")
    lo = jax.lax.slice_in_dim(values, 0, n // 2, axis=axis).astype(jnp.int32)
    hi = jax.lax.slice_in_dim(values, n // 2, n, axis=axis).astype(jnp.int32)
    return ((hi << 4) | (lo & 0xF)).astype(jnp.int8)


def unpack_int4(packed: jax.Array, out_dtype=jnp.int8, axis: int = -1
                ) -> jax.Array:
    """Inverse of the int4 packing along ``axis``: (…, n/2, …) int8 ->
    (…, n, …) values in [-8, 7], low nibbles first then high nibbles
    (split-halves layout)."""
    p = packed.astype(jnp.int32)
    lo = (p << 28) >> 28  # sign-extend the low nibble
    hi = (p << 24) >> 28  # arithmetic shift sign-extends the high nibble
    return jnp.concatenate([lo, hi], axis=axis).astype(out_dtype)


def quantize_head_wise(t: jax.Array, qdtype=jnp.float8_e4m3fn):
    """(B, H, S, D) -> values + (B, H) scales (reference nn.py:410-414)."""
    qmax = INT8_MAX if jnp.issubdtype(qdtype, jnp.integer) else FP8_E4M3_MAX
    return _dynamic_quantize(t, (-2, -1), qmax, qdtype)


def quantize_token_wise(t: jax.Array, qdtype=jnp.float8_e4m3fn):
    """(B, H, S, D) -> values + (B, H, S) scales (reference nn.py:415-418)."""
    qmax = INT8_MAX if jnp.issubdtype(qdtype, jnp.integer) else FP8_E4M3_MAX
    return _dynamic_quantize(t, (-1,), qmax, qdtype)


def quantize_channel_wise(t: jax.Array, qdtype=jnp.int8):
    """(B, H, S, D) -> values + (B, H, D) scales (reduce over sequence).

    Per-channel granularity is what makes an 8-bit P@V matmul possible: the
    per-channel scale factors out of the sum over KV positions, so the int32
    accumulator dequantizes with one row-vector multiply in the epilogue
    (beyond the reference, which keeps V in fp16/bf16 — nn.py:83-105).
    """
    qmax = INT8_MAX if jnp.issubdtype(qdtype, jnp.integer) else FP8_E4M3_MAX
    return _dynamic_quantize(t, (-2,), qmax, qdtype)


def dequantize(
    t_q: jax.Array, scale: jax.Array, dtype=jnp.float32, axis: int = None
) -> jax.Array:
    """Inverse transform.

    With ``axis=None`` (head-wise/token-wise scales) the scale shape is a
    leading prefix of the tensor shape, so trailing axes are appended —
    the reference's unsqueeze-right semantics (ops.py:75-86).  For scales
    whose reduced axis is interior (e.g. channel-wise (B, H, D) from
    ``quantize_channel_wise``), pass the reduced ``axis`` (-2 there) so the
    scale re-expands in the right place.
    """
    scale = scale.astype(dtype)
    if axis is not None:
        scale = jnp.expand_dims(scale, axis)
    while scale.ndim < t_q.ndim:
        scale = scale[..., None]
    return t_q.astype(dtype) * scale
