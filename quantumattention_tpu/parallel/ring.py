"""Ring sequence-parallel attention over a mesh axis.

The reference has no cross-device story at all (SURVEY.md §2.3); this module
is the long-context scale-out. KV shards rotate around the mesh axis with
``jax.lax.ppermute`` (point-to-point over NVLink) while each card runs
the fused flash kernel on the shard currently in front of it; partial
(out, m, l) triples merge with the same online-softmax rescale math the
kernel uses between KV tiles (reference merge operator:
tk/attention.py:274-313 — here applied across chips instead of tiles).

XLA's latency-hiding scheduler overlaps each step's ppermute with the next
step's kernel; after N-1 rotations every chip has seen every KV block.

Causal masking stays correct during rotation because the kernel takes
explicit q/kv position offsets (flash.py q_offset/kv_offset): chip r holds
Q rows [r*Sq_local, ...) forever, while the KV block that arrived at step t
originated on chip (r - t) mod N and carries that chip's global offset.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import config
from ..ops.flash import flash_attention


def _merge_unnormalized(u, m, l, o_t, m_t, l_t):
    """Fold one ring step's normalized partial (o_t, m_t, l_t) into the
    running UNNORMALIZED accumulator (u, m, l).

    Carrying u = sum(exp-weighted V rows) instead of a normalized output
    halves the per-step VPU work of the old renormalizing merge (no divide
    + re-multiply each step); the single division happens once at ring
    exit.  Same rescale math as the kernel between KV tiles (reference
    merge operator tk/attention.py:274-313), applied across chips:

      m' = max(m, m_t)
      u' = u*e^(m-m') + o_t*l_t*e^(m_t-m')
      l' = l*e^(m-m') + l_t*e^(m_t-m')

    The exponent base must match the kernel's softmax domain
    (config.kernel.use_exp2), read at trace time like the kernel does.
    """
    exp = jnp.exp2 if config.kernel.use_exp2 else jnp.exp
    m_new = jnp.maximum(m, m_t)
    # A side that has seen no key yet carries m = -inf and weighs zero
    # (also when both do: -inf - -inf would be NaN).
    a = jnp.where(m == -jnp.inf, 0.0, exp(m - m_new))
    b = jnp.where(m_t == -jnp.inf, 0.0, exp(m_t - m_new))
    u_new = u * a[..., None] + o_t.astype(jnp.float32) * (l_t * b)[..., None]
    l_new = l * a + l_t * b
    return u_new, m_new, l_new


def _ring_body(
    q,
    k,
    v,
    *args,
    axis_name: str,
    is_causal: bool,
    sm_scale: Optional[float],
    window: Optional[Tuple[Optional[int], Optional[int]]],
    block_q: Optional[int],
    block_kv: Optional[int],
    has_scales: bool,
):
    """shard_map body: q/k/v are the local (B, H, S_local, D) shards; args
    carries (scale_q, scale_k) when quantized — head-wise (B, H) scales
    replicate; token-wise (B, H, S_local) scale_k shards rotate with KV."""
    scale_q, scale_k = args if has_scales else (None, None)
    tokenwise = has_scales and scale_q.ndim == 3
    n = jax.lax.axis_size(axis_name)
    rank = jax.lax.axis_index(axis_name)
    q_len = q.shape[2]
    kv_len = k.shape[2]
    q_off = rank * q_len

    perm = [(i, (i + 1) % n) for i in range(n)]

    def step(carry, t):
        u, m, l, k_blk, v_blk, sk_blk = carry
        src = (rank - t) % n
        kv_off = src * kv_len

        def compute(operand):
            u, m, l = operand
            o_t, (m_t, l_t) = flash_attention(
                q,
                k_blk,
                v_blk,
                scale_q=scale_q,
                scale_k=sk_blk if tokenwise else scale_k,
                is_causal=is_causal,
                sm_scale=sm_scale,
                window=window,
                q_offset=q_off,
                kv_offset=kv_off,
                block_q=block_q,
                block_kv=block_kv,
                return_residuals=True,
            )
            return _merge_unnormalized(u, m, l, o_t, m_t, l_t)

        if is_causal:
            # A KV shard strictly above this chip's diagonal contributes
            # nothing: skip the whole kernel launch (the cross-chip
            # analogue of the kernel's block-level causal skip).  Shards
            # and Q rows have equal extents, so "src > rank" is exactly
            # the fully-masked condition.
            u, m, l = jax.lax.cond(
                kv_off <= q_off + q_len - 1,
                compute,
                lambda operand: operand,
                (u, m, l),
            )
        else:
            u, m, l = compute((u, m, l))
        # Rotate KV (and token-wise K scales) to the next chip.  The final
        # rotation is semantically redundant, but keeping it unconditional
        # lets XLA pipeline the loop; it returns KV to its home chip.
        k_nxt = jax.lax.ppermute(k_blk, axis_name, perm)
        v_nxt = jax.lax.ppermute(v_blk, axis_name, perm)
        sk_nxt = (
            jax.lax.ppermute(sk_blk, axis_name, perm) if tokenwise else sk_blk
        )
        return (u, m, l, k_nxt, v_nxt, sk_nxt), None

    batch, heads, _, head_dim = q.shape
    u0 = jnp.zeros((batch, heads, q_len, head_dim), jnp.float32)
    m0 = jnp.full((batch, heads, q_len), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((batch, heads, q_len), jnp.float32)
    sk0 = scale_k if tokenwise else jnp.zeros((), jnp.float32)

    # No unroll: compile time stays flat in the ring size (an unrolled
    # 16-chip pod axis would inline 16 kernel calls into one XLA graph).
    (u, _, l, _, _, _), _ = jax.lax.scan(
        step, (u0, m0, l0, k, v, sk0), jnp.arange(n)
    )
    l_lead = l[..., None]
    o = u * jnp.where(l_lead == 0.0, 0.0, 1.0 / l_lead)
    # Match flash_attention's output contract: 8-bit value dtypes promote
    # to bf16 (casting the merged fp32 result to fp8 would silently
    # saturate/quantize it).
    out_dtype = v.dtype
    if jnp.dtype(out_dtype).itemsize == 1:
        out_dtype = jnp.bfloat16
    return o.astype(out_dtype)


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    mesh: Mesh,
    axis_name: str = "sp",
    scale_q: Optional[jax.Array] = None,
    scale_k: Optional[jax.Array] = None,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> jax.Array:
    """Sequence-parallel fused attention over ``mesh[axis_name]``.

    Args:
      q/k/v: (B, H, S, D) global arrays; S is sharded over ``axis_name``
        (other dims may be sharded over other mesh axes by the caller's jit).
      scale_q/scale_k: optional dequantization scales for pre-quantized
        fp8/int8 q/k.  Head-wise (B, H)/(B, Hkv) scales are position-
        independent and replicate across the ring; token-wise (B, H, S)
        scales shard over ``axis_name`` and scale_k rotates alongside its
        KV payload.  Either way the quantized KV halves the ICI traffic
        vs a bf16 ring.

    Returns (B, H, S, D) with the same sequence sharding as q.
    """
    has_scales = scale_q is not None
    if has_scales and scale_q.ndim not in (2, 3):
        raise ValueError(
            "ring_attention scales must be head-wise (B, H) or token-wise "
            f"(B, H, S); got rank {scale_q.ndim}"
        )
    if has_scales and scale_q.ndim != scale_k.ndim:
        raise ValueError("scale_q/scale_k rank mismatch")
    body = functools.partial(
        _ring_body,
        axis_name=axis_name,
        is_causal=is_causal,
        sm_scale=sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1]),
        window=window,
        block_q=block_q,
        block_kv=block_kv,
        has_scales=has_scales,
    )
    spec = P(None, None, axis_name, None)
    if has_scales:
        # Head-wise scales are position-independent and replicate across
        # the ring; token-wise scales are per-position and shard over the
        # sequence axis — scale_k then rotates alongside its KV shard.
        scale_spec = (
            P(None, None) if scale_q.ndim == 2 else P(None, None, axis_name)
        )
        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec, spec, scale_spec, scale_spec),
            out_specs=spec,
            check_vma=False,
        )(q, k, v, scale_q, scale_k)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )(q, k, v)
