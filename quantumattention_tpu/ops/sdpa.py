"""Reference scaled-dot-product attention (XLA path).

This module plays the role the reference assigns to
``aten.scaled_dot_product_attention``: it is simultaneously

  1. the *numerical-semantics definition* of every fused op (reference:
     src/quantum_attn/ops.py:17-29 and :64-95, where the FP8 op is defined as
     dequantize-then-SDPA),
  2. the *accuracy oracle* for differential tests (reference:
     tests/test_interface.py:13-15,57-59), and
  3. the *graceful fallback* target for the ``*_with_fallback`` entry points
     (reference: quantum_attn_interface.py:90-98).

It is plain jnp so XLA fuses/parallelizes it freely, it is differentiable,
and it supports the superset of masking the fused kernels implement
(causal, additive/boolean masks, GQA, sliding window, segment ids).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

#: Large-negative logit used instead of -inf so fully-masked rows do not
#: produce NaNs through exp(-inf - (-inf)).
DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

#: float32 products at full precision: on the GPU the default precision
#: runs them in TF32, which keeps about three decimal digits.
_HIGHEST = jax.lax.Precision.HIGHEST


def _dequantize(t: jax.Array, scale: Optional[jax.Array], target_dtype) -> jax.Array:
    """Cast ``t`` to ``target_dtype``, multiplying by broadcast scales.

    Matches the reference FP8 op's dequantization semantics
    (ops.py:75-86): scales are unsqueezed on the right up to the tensor
    rank, then multiplied in.
    """
    t = t.astype(target_dtype)
    if scale is not None:
        scale = scale.astype(target_dtype)
        while scale.ndim < t.ndim:
            scale = scale[..., None]
        t = t * scale
    return t


def sdpa_reference(
    query: jax.Array,
    key: jax.Array,
    value: jax.Array,
    attn_mask: Optional[jax.Array] = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Optional[jax.Array] = None,
    scale_k: Optional[jax.Array] = None,
    window: Optional[tuple] = None,
    q_segment_ids: Optional[jax.Array] = None,
    kv_segment_ids: Optional[jax.Array] = None,
    dropout_key: Optional[jax.Array] = None,
    compute_dtype=jnp.float32,
    out_dtype=None,
) -> jax.Array:
    """Unfused attention over (B, H, S, D) tensors.

    GQA is supported when ``num_q_heads % num_kv_heads == 0`` (the reference
    allows this in its C++ host wrapper, tk/attention.py:398-402).

    ``window`` is ``(left, right)`` sliding-window extents: query position i
    may attend to kv position j when ``i - left <= j <= i + right`` (use
    ``None`` for an unbounded side).  The reference has no sliding window;
    this is part of this build's extended capability (SURVEY.md section 7).
    """
    if out_dtype is None:
        out_dtype = value.dtype
    batch, num_q_heads, q_len, head_dim = query.shape
    _, num_kv_heads, kv_len, _ = key.shape
    if num_q_heads % num_kv_heads != 0:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be divisible by num_kv_heads "
            f"({num_kv_heads})"
        )

    q = _dequantize(query, scale_q, compute_dtype)
    k = _dequantize(key, scale_k, compute_dtype)
    v = value.astype(compute_dtype)

    if num_kv_heads != num_q_heads:
        rep = num_q_heads // num_kv_heads
        k = jnp.repeat(k, rep, axis=1)
        v = jnp.repeat(v, rep, axis=1)

    sm_scale = 1.0 / math.sqrt(head_dim) if scale is None else scale
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=_HIGHEST) * sm_scale

    mask = None

    def _and(m, new):
        return new if m is None else jnp.logical_and(m, new)

    if is_causal or window is not None:
        q_pos = jnp.arange(q_len)[:, None]
        kv_pos = jnp.arange(kv_len)[None, :]
        if is_causal:
            mask = _and(mask, kv_pos <= q_pos)
        if window is not None:
            left, right = window
            if left is not None:
                mask = _and(mask, kv_pos >= q_pos - left)
            if right is not None:
                mask = _and(mask, kv_pos <= q_pos + right)
    if q_segment_ids is not None or kv_segment_ids is not None:
        if q_segment_ids is None or kv_segment_ids is None:
            raise ValueError("both q/kv segment ids must be provided")
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        seg = seg[:, None, :, :]  # (B, 1, Sq, Skv)
        mask = seg if mask is None else jnp.logical_and(mask, seg)

    if mask is not None:
        logits = jnp.where(mask, logits, DEFAULT_MASK_VALUE)

    if attn_mask is not None:
        if attn_mask.dtype == jnp.bool_:
            logits = jnp.where(attn_mask, logits, DEFAULT_MASK_VALUE)
        else:
            logits = logits + attn_mask.astype(compute_dtype)

    weights = jax.nn.softmax(logits, axis=-1)

    if dropout_p > 0.0:
        if dropout_key is None:
            raise ValueError(
                "dropout_p > 0 requires dropout_key (JAX uses functional RNG)"
            )
        keep = jax.random.bernoulli(dropout_key, 1.0 - dropout_p, weights.shape)
        weights = jnp.where(keep, weights / (1.0 - dropout_p), 0.0)

    out = jnp.einsum("bhqk,bhkd->bhqd", weights, v, precision=_HIGHEST)
    return out.astype(out_dtype)


def sdpa_per_head(
    query: jax.Array,
    key: jax.Array,
    value: jax.Array,
    *,
    is_causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[tuple] = None,
    out_dtype=None,
) -> jax.Array:
    """:func:`sdpa_reference` computed one (batch, query head) at a time.

    ``lax.map`` over B*Hq keeps one head's (Sq, Skv) fp32 logits live
    (268 MB at S = 8192) instead of all of them, and each head is
    rematerialised in the backward pass, so the VJP of this function is
    the plain attention backward in O(S^2) memory per head only.
    """
    if out_dtype is None:
        out_dtype = value.dtype
    batch, num_q_heads, q_len, head_dim = query.shape
    _, num_kv_heads, kv_len, _ = key.shape
    group = num_q_heads // num_kv_heads
    n = jnp.arange(batch * num_q_heads)
    kv_index = (n // num_q_heads) * num_kv_heads + (n % num_q_heads) // group
    k2 = key.reshape(batch * num_kv_heads, 1, 1, kv_len, head_dim)
    v2 = value.reshape(batch * num_kv_heads, 1, 1, kv_len, head_dim)
    q2 = query.reshape(batch * num_q_heads, 1, 1, q_len, head_dim)

    @jax.checkpoint
    def one(xs):
        q_i, kv_i = xs
        return sdpa_reference(
            q_i, k2[kv_i], v2[kv_i], is_causal=is_causal, scale=scale,
            window=window, out_dtype=out_dtype,
        )

    out = jax.lax.map(one, (q2, kv_index))
    return out.reshape(batch, num_q_heads, q_len, head_dim)
