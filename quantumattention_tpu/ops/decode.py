"""GQA decode attention over a ragged (quantized) KV cache.

The reference has no decode path at all — its kernels are prefill-only
(SURVEY.md §0: "no KV cache or decode path").  This is the serving hot
path: one new token (or T verification candidates) per sequence against a
cache of ``max_len`` rows of which only ``lengths[b]`` are live.

Shape model:
  q:        (B, Hq, D) current-step queries, or (B, Hq, T, D) for T
            speculative candidates per slot
  k_cache:  (B, Hkv, Smax, D) ragged cache, only lengths[b] rows valid
            (minor dim D/2: the packed-int4 container)
  v_cache:  (B, Hkv, Smax, D)
  k_scale/v_scale: (B, Hkv, Smax) fp32 token-wise dequant scales when the
            cache is 8-bit
  lengths:  (B,) int32 valid lengths (entries may be 0 for empty slots)

Two implementations of the same semantics:

  * ``_decode_kernel`` — Pallas through Triton, split over KV
    (flash-decoding): grid ``(B, Hkv, splits)``; each program reads its
    slot's length and loops only over the live KV tiles of its split, so
    the int8 cache is read in proportion to live length.  The GQA group
    (x candidate tokens) is the dot's M dimension.  A second pass in XLA
    merges the splits' online-softmax states.
  * ``decode_attention_plain`` — XLA over all ``Smax`` rows, with the
    token-wise scales applied to the score and probability tiles so the
    int8 -> bf16 convert is the dot's only prologue.

Both apply the same online-softmax merge operator as the prefill kernel
(reference tk/attention.py:274-313), in the exp2 domain.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import config
from ..utils import checks
from . import quant as quant_ops

LOG2E = math.log2(math.e)
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

#: KV rows per loop step of the decode kernel.
DECODE_BLOCK_KV = 128

#: Programs to keep in flight: eight per SM of a 132-SM Hopper card (on
#: an H200 at B=64, S=4096 this ran 0.439 ms against 0.466 ms for four per
#: SM at full length, 0.336 against 0.357 ms at half).
TARGET_PROGRAMS = 8 * 132


class _DecodeSpec(NamedTuple):
    quantized: bool
    sm_scale: float
    block_kv: int
    split_len: int
    q_tokens: int
    window_left: Optional[int]


def _decode_kernel(*refs, spec: _DecodeSpec):
    if spec.quantized:
        len_ref, q_ref, k_ref, v_ref, ks_ref, vs_ref, acc_ref, m_ref, l_ref = refs
    else:
        len_ref, q_ref, k_ref, v_ref, acc_ref, m_ref, l_ref = refs
    bkv, t_count = spec.block_kv, spec.q_tokens
    split = pl.program_id(2)
    length = len_ref[...]
    start = split * spec.split_len
    end = jnp.minimum(start + spec.split_len, length)
    if spec.window_left is not None:
        # The lowest column any candidate keeps is length - T - left.
        start = jnp.maximum(start, length - t_count - spec.window_left)
    lo = lax.div(jnp.maximum(start, 0), bkv)
    hi = lax.div(jnp.maximum(end, 0) + bkv - 1, bkv)

    q = q_ref[...].astype(jnp.bfloat16)  # (Mp, D)
    m_rows = q.shape[0]
    # Rows pack (group, token) pairs token-fastest; candidate t must not
    # see candidates t+1..T-1, so its columns shift by T - 1 - t.
    shift = (t_count - 1) - lax.broadcasted_iota(
        jnp.int32, (m_rows, bkv), 0
    ) % t_count
    base = spec.sm_scale * LOG2E

    def body(j, carry):
        acc, m_prev, l_prev = carry
        kv_slice = pl.ds(j * bkv, bkv)
        k = k_ref[kv_slice, :].astype(jnp.bfloat16)
        s = lax.dot_general(
            q, k, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        ) * base
        if spec.quantized:
            s = s * ks_ref[kv_slice][None, :]
        col = j * bkv + lax.broadcasted_iota(jnp.int32, (m_rows, bkv), 1) + shift
        keep = col < length
        if spec.window_left is not None:
            keep &= col >= length - 1 - spec.window_left
        s = jnp.where(keep, s, MASK_VALUE)
        m_next = jnp.maximum(m_prev, jnp.max(s, axis=1))
        alpha = jnp.exp2(m_prev - m_next)
        p = jnp.exp2(s - m_next[:, None])
        l_next = alpha * l_prev + jnp.sum(p, axis=1)
        if spec.quantized:
            # The token-wise V scale commutes through the KV sum: apply it
            # to P's columns instead of V's rows.
            p = p * vs_ref[kv_slice][None, :]
        v = v_ref[kv_slice, :].astype(jnp.bfloat16)
        pv = lax.dot_general(
            p.astype(jnp.bfloat16), v, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return acc * alpha[:, None] + pv, m_next, l_next

    head_dim = q.shape[1]
    acc, m_i, l_i = lax.fori_loop(
        lo, hi, body,
        (
            jnp.zeros((m_rows, head_dim), jnp.float32),
            jnp.full((m_rows,), -jnp.inf, jnp.float32),
            jnp.zeros((m_rows,), jnp.float32),
        ),
    )
    acc_ref[...] = acc
    m_ref[...] = m_i
    l_ref[...] = l_i


def _num_splits(batch: int, kv_heads: int, s_max: int, block_kv: int) -> int:
    """Splits of the KV axis so that B * Hkv * splits programs fill the
    card, each with at least one KV tile."""
    splits = 1
    while (
        batch * kv_heads * splits < TARGET_PROGRAMS
        and s_max // (2 * splits) >= block_kv
    ):
        splits *= 2
    return splits


def decode_tiling(batch: int, kv_heads: int, s_max: int,
                  block_kv: Optional[int] = None) -> Tuple[int, int, int]:
    """(block_kv, splits, split_len) of the decode kernel: power-of-two
    tiles, and splits whose extents tile ``s_max`` (no padding of the
    cache when ``s_max`` is a multiple of ``block_kv * splits``)."""
    bkv = block_kv or DECODE_BLOCK_KV
    if bkv < 16 or bkv & (bkv - 1):
        raise ValueError(f"block_kv must be a power of two >= 16, got {bkv}")
    bkv = min(bkv, max(16, pl.next_power_of_2(s_max)))
    splits = _num_splits(batch, kv_heads, s_max, bkv)
    split_len = -(-s_max // (splits * bkv)) * bkv
    return bkv, splits, split_len


def decode_stages(m_pad: int, block_kv: int, head_dim: int,
                  kv_bytes: int) -> int:
    """Deepest K/V pipeline (3, 2 or 1 stages) the shared-memory fit model
    admits; raises when the tile cannot run at all."""
    from .. import autotune

    for stages in (3, 2, 1):
        if autotune.smem_fits(m_pad, block_kv, head_dim, 2, kv_bytes, stages):
            return stages
    raise ValueError(
        f"decode tile block_kv={block_kv} at head_dim {head_dim} exceeds one "
        f"block's shared memory ({autotune.SMEM_BYTES} bytes)"
    )


def _decode_kernel_call(qg, k_cache, v_cache, lengths, k_scale, v_scale, *,
                        sm_scale, q_tokens, window_left, block_kv, interpret):
    batch, num_kv_heads, m_pad, head_dim = qg.shape
    s_max = k_cache.shape[2]
    bkv, splits, split_len = decode_tiling(batch, num_kv_heads, s_max, block_kv)
    stages = decode_stages(m_pad, bkv, head_dim, k_cache.dtype.itemsize)
    s_pad = split_len * splits
    quantized = k_scale is not None
    if s_pad != s_max:
        pad4 = [(0, 0), (0, 0), (0, s_pad - s_max), (0, 0)]
        k_cache = jnp.pad(k_cache, pad4)
        v_cache = jnp.pad(v_cache, pad4)
        if quantized:
            pad3 = [(0, 0), (0, 0), (0, s_pad - s_max)]
            k_scale = jnp.pad(k_scale, pad3)
            v_scale = jnp.pad(v_scale, pad3)

    in_specs = [
        pl.BlockSpec((None,), lambda b, h, s: (b,)),
        pl.BlockSpec((None, None, m_pad, head_dim), lambda b, h, s: (b, h, 0, 0)),
        pl.BlockSpec((None, None, s_pad, head_dim), lambda b, h, s: (b, h, 0, 0)),
        pl.BlockSpec((None, None, s_pad, head_dim), lambda b, h, s: (b, h, 0, 0)),
    ]
    args = [lengths.astype(jnp.int32), qg, k_cache, v_cache]
    if quantized:
        scale_spec = pl.BlockSpec((None, None, s_pad), lambda b, h, s: (b, h, 0))
        in_specs += [scale_spec, scale_spec]
        args += [k_scale.astype(jnp.float32), v_scale.astype(jnp.float32)]
    part = (splits, batch, num_kv_heads, m_pad)
    spec = _DecodeSpec(
        quantized=quantized,
        sm_scale=float(sm_scale),
        block_kv=bkv,
        split_len=split_len,
        q_tokens=q_tokens,
        window_left=window_left,
    )
    acc, m, l = pl.pallas_call(
        functools.partial(_decode_kernel, spec=spec),
        grid=(batch, num_kv_heads, splits),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, m_pad, head_dim),
                         lambda b, h, s: (s, b, h, 0, 0)),
            pl.BlockSpec((None, None, None, m_pad), lambda b, h, s: (s, b, h, 0)),
            pl.BlockSpec((None, None, None, m_pad), lambda b, h, s: (s, b, h, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct(part + (head_dim,), jnp.float32),
            jax.ShapeDtypeStruct(part, jnp.float32),
            jax.ShapeDtypeStruct(part, jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=stages),
        interpret=interpret,
        name="qa_decode_split",
    )(*args)
    # Merge the splits' online-softmax states; splits that saw no live row
    # carry m = -inf and weigh zero.
    m_tot = jnp.max(m, axis=0)
    w = jnp.where(m == -jnp.inf, 0.0, jnp.exp2(m - m_tot[None]))
    l_tot = jnp.sum(w * l, axis=0)
    o = jnp.sum(w[..., None] * acc, axis=0)
    o = o * jnp.where(l_tot == 0.0, 0.0, 1.0 / l_tot)[..., None]
    return o


def decode_attention_plain(
    q: jax.Array,
    k_cache: jax.Array,
    v_cache: jax.Array,
    lengths: jax.Array,
    *,
    k_scale: Optional[jax.Array] = None,
    v_scale: Optional[jax.Array] = None,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> jax.Array:
    """XLA decode attention with the same contract as
    :func:`decode_attention`: reads all ``Smax`` rows of every slot."""
    qg, dims = _group_queries(q, k_cache)
    batch, num_kv_heads, q_tokens, head_dim, m_rows = dims
    k_cache, v_cache = _unpacked(q, k_cache, v_cache)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    window_left = _window_left(window)
    s = jnp.einsum(
        "bkmd,bksd->bkms", qg.astype(jnp.bfloat16),
        k_cache.astype(jnp.bfloat16), preferred_element_type=jnp.float32,
    ) * (sm_scale * LOG2E)
    if k_scale is not None:
        s = s * k_scale.astype(jnp.float32)[:, :, None, :]
    s_max = k_cache.shape[2]
    col = jnp.arange(s_max)[None, :] + (
        (q_tokens - 1) - jnp.arange(m_rows)[:, None] % q_tokens
    )
    lens = lengths.astype(jnp.int32)[:, None, None, None]
    keep = col[None, None] < lens
    if window_left is not None:
        keep &= col[None, None] >= lens - 1 - window_left
    s = jnp.where(keep, s, MASK_VALUE)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp2(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    if v_scale is not None:
        p = p * v_scale.astype(jnp.float32)[:, :, None, :]
    o = jnp.einsum(
        "bkms,bksd->bkmd", p.astype(jnp.bfloat16),
        v_cache.astype(jnp.bfloat16), preferred_element_type=jnp.float32,
    ) / l
    o = jnp.where(lens > 0, o, 0.0)
    return o.astype(jnp.bfloat16).reshape(q.shape)


def _group_queries(q, k_cache):
    if q.ndim == 4:
        batch, num_q_heads, q_tokens, head_dim = q.shape
    else:
        batch, num_q_heads, head_dim = q.shape
        q_tokens = 1
    num_kv_heads = k_cache.shape[1]
    if num_q_heads % num_kv_heads != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    m_rows = (num_q_heads // num_kv_heads) * q_tokens
    # (group, T) rows pack token-fastest.
    qg = q.reshape(batch, num_kv_heads, m_rows, head_dim)
    return qg, (batch, num_kv_heads, q_tokens, head_dim, m_rows)


def _unpacked(q, k_cache, v_cache):
    """Unpack a packed-int4 cache (minor dim head_dim/2) to int8 values."""
    if k_cache.shape[-1] * 2 == q.shape[-1]:
        return (quant_ops.unpack_int4(k_cache, jnp.int8),
                quant_ops.unpack_int4(v_cache, jnp.int8))
    return k_cache, v_cache


def _window_left(window) -> Optional[int]:
    if window is None:
        return None
    left, right = window
    if right not in (None, 0):
        raise ValueError(
            "decode_attention window must be (left, 0) or (left, None): "
            f"queries are the newest tokens, got right={right}"
        )
    return None if left is None else int(left)


def decode_attention(
    q: jax.Array,
    k_cache: jax.Array,
    v_cache: jax.Array,
    lengths: jax.Array,
    *,
    k_scale: Optional[jax.Array] = None,
    v_scale: Optional[jax.Array] = None,
    sm_scale: Optional[float] = None,
    block_kv: Optional[int] = None,
    block_batch: Optional[int] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    interpret: Optional[bool] = None,
) -> jax.Array:
    """Single-step GQA decode attention; returns q's shape in bf16.

    ``block_kv`` is the kernel's KV tile (a power of two, default
    ``DECODE_BLOCK_KV``).  ``block_batch`` must divide the batch; the
    kernel runs one slot per program whatever its value.

    ``k_scale``/``v_scale`` must both be given iff the cache is 8-bit
    token-wise quantized (shape (B, Hkv, Smax) fp32).  A cache with minor
    dim ``head_dim // 2`` is the packed-int4 container
    (``ops/quant.dynamically_quantize_int4``), unpacked by XLA.

    4-D ``q`` = (B, Hq, T, D): T candidate tokens per slot (speculative
    verification); ``lengths`` must already INCLUDE the T appended
    candidates, and token t attends to everything before the candidates
    plus candidates 0..t (intra-chunk causal).  A sliding ``window`` is
    (left, 0) or (left, None).
    """
    qg, dims = _group_queries(q, k_cache)
    batch, num_kv_heads, q_tokens, head_dim, m_rows = dims
    cache_dim = k_cache.shape[-1]
    int4 = cache_dim * 2 == head_dim
    if int4 and k_cache.dtype != jnp.int8:
        raise ValueError(
            "packed-int4 cache (minor dim = head_dim/2) must use an int8 "
            f"container, got {k_cache.dtype}"
        )
    if not int4 and cache_dim != head_dim:
        raise ValueError(
            f"cache head dim {cache_dim} matches neither head_dim "
            f"({head_dim}) nor the packed-int4 layout ({head_dim // 2})"
        )
    if checks.is_8bit_dtype(q.dtype):
        raise ValueError(
            "decode_attention expects float queries (the cache may be "
            "8-bit, but q has no dequant-scale path)"
        )
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be given together")
    if checks.is_8bit_dtype(k_cache.dtype) and not quantized:
        raise ValueError("8-bit KV cache requires k_scale/v_scale")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    window_left = _window_left(window)
    if block_batch is not None and batch % block_batch != 0:
        raise ValueError(
            f"block_batch ({block_batch}) must divide batch ({batch})"
        )
    if interpret is None:
        interpret = checks.resolve_interpret(config.interpret)
    k_cache, v_cache = _unpacked(q, k_cache, v_cache)

    m_pad = max(16, pl.next_power_of_2(m_rows))
    if m_pad != m_rows:
        qg = jnp.pad(qg, [(0, 0), (0, 0), (0, m_pad - m_rows), (0, 0)])
    o = _decode_kernel_call(
        qg, k_cache, v_cache, lengths, k_scale, v_scale,
        sm_scale=sm_scale, q_tokens=q_tokens, window_left=window_left,
        block_kv=block_kv, interpret=interpret,
    )
    return o[:, :, :m_rows].astype(jnp.bfloat16).reshape(q.shape)
