"""Quantized ragged KV cache for decode serving.

The reference has no KV-cache subsystem (SURVEY.md §0); this is part of
this build's serving extension.  The cache is a plain pytree of device arrays
with static shapes (jit-stable slot-based layout — continuous batching
rotates requests through fixed slots rather than reshaping):

  k / v:            (num_slots, Hkv, Smax, D)   int8 (default), fp8, or bf16
  k_scale/v_scale:  (num_slots, Hkv, Smax)      fp32 (8-bit caches only)
  lengths:          (num_slots,)                int32 valid lengths

Token-wise quantization (reduction over D) matches the engine's token-wise
scale granularity (reference nn.py:415-418); int8 is the default container
(half the HBM traffic of bf16 — decode is bandwidth-bound).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import quant
from ..utils import checks


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    k: jax.Array
    v: jax.Array
    lengths: jax.Array
    k_scale: Optional[jax.Array] = None
    v_scale: Optional[jax.Array] = None

    @property
    def num_slots(self) -> int:
        return self.k.shape[0]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(
    num_slots: int,
    num_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype=jnp.int8,
    int4: bool = False,
) -> KVCache:
    """``int4=True`` stores packed 4-bit values (two per int8 byte, minor
    dim head_dim/2 — ops/quant.dynamically_quantize_int4): half the int8
    cache's HBM stream and residency, ~2x its rounding error.  The decode
    kernel detects the packed layout from the cache's minor dim."""
    if int4:
        if dtype != jnp.int8:
            raise ValueError("int4 cache uses an int8 container")
        if head_dim % 2 != 0:
            raise ValueError("int4 cache requires an even head_dim")
        head_dim //= 2
    shape = (num_slots, num_kv_heads, max_len, head_dim)
    cache = KVCache(
        k=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        lengths=jnp.zeros((num_slots,), jnp.int32),
    )
    if checks.is_8bit_dtype(dtype):
        cache.k_scale = jnp.ones((num_slots, num_kv_heads, max_len), jnp.float32)
        cache.v_scale = jnp.ones((num_slots, num_kv_heads, max_len), jnp.float32)
    return cache


def _quantize_tokens(
    t: jax.Array, dtype, int4: bool = False
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """(H, S, D) float -> (values, (H, S) scales) in the cache container."""
    if not checks.is_8bit_dtype(dtype):
        return t.astype(dtype), None
    if int4:
        tq, scale = quant.dynamically_quantize_int4(t, reduction_dim=-1)
    elif dtype == jnp.int8:
        tq, scale = quant.dynamically_quantize_int8(t, reduction_dim=-1)
    else:
        tq, scale = quant.dynamically_quantize_fp8(t, reduction_dim=-1)
    return tq, scale


@jax.jit
def append(
    cache: KVCache,
    slot_ids: jax.Array,
    k_new: jax.Array,
    v_new: jax.Array,
    offsets: jax.Array,
    n_valid: jax.Array,
) -> KVCache:
    """Write n_valid[i] new tokens for each slot and bump its length.

    Args:
      slot_ids: (N,) int32 cache slots to write.
      k_new/v_new: (N, Hkv, T, D) float tokens (T = chunk length, padded).
      offsets: (N,) int32 write positions (== current lengths for decode,
        chunk offsets for chunked prefill).
      n_valid: (N,) int32 how many of the T tokens are real.

    Returns the updated cache.  (No donation here: donating these buffers
    corrupts later reads through retained aliases on the CPU runtime; the
    serving engine's outer decode jit donates at its own boundary instead,
    so the steady-state decode loop still updates in place.)
    """
    dtype = cache.k.dtype
    # Packed-int4 layout is identified by the halved minor dim (static at
    # trace time).
    int4 = cache.k.shape[-1] * 2 == k_new.shape[-1]

    # Batched quantize for EVERY slot in one op (token-wise scales reduce
    # over the last axis only, so this is bit-identical to per-slot).
    kq, ks = _quantize_tokens(k_new, dtype, int4)
    vq, vs = _quantize_tokens(v_new, dtype, int4)
    t = k_new.shape[2]
    lengths = cache.lengths.at[slot_ids].set(offsets + n_valid)

    if t == 1:
        # Decode write: ONE scatter per cache array.  (The per-slot
        # fori_loop was a measured decode-step bottleneck: 16 slots x 4-5
        # tiny sequential ops x 32 layers of per-op dispatch overhead per
        # step.)  Distinct (slot, row) pairs, so order-independent.
        rows = offsets[:, None]
        sids = slot_ids[:, None]
        # Advanced indices (N, 1) at dims 0 and 2, separated by the head
        # slice — the indexed view is (N, 1, H, D'); move T forward in
        # the updates to match.  Decode always writes slot_ids =
        # arange(num_slots): the index tuples are slot-major sorted and
        # unique, which lets XLA lower the scatter without the sort/
        # dedup machinery (the un-hinted scatter measured 4.3 ms across a
        # 32-layer step at B=64 — benchmarks/decode_phase_probe.py).
        hints = dict(indices_are_sorted=True, unique_indices=True)
        ck = cache.k.at[sids, :, rows].set(
            kq.transpose(0, 2, 1, 3), **hints
        )
        cv = cache.v.at[sids, :, rows].set(
            vq.transpose(0, 2, 1, 3), **hints
        )
        cks, cvs = cache.k_scale, cache.v_scale
        if ks is not None:
            cks = cks.at[sids, :, rows].set(ks.transpose(0, 2, 1), **hints)
            cvs = cvs.at[sids, :, rows].set(vs.transpose(0, 2, 1), **hints)
        return KVCache(k=ck, v=cv, lengths=lengths, k_scale=cks, v_scale=cvs)

    # Chunked/prefill write (T tokens per slot, few slots): contiguous
    # dynamic_update_slice per slot instead of a (N*T)-row scatter.
    def write_one(carry, i):
        cache_k, cache_v, cache_ks, cache_vs = carry
        slot = slot_ids[i]
        off = offsets[i]
        cache_k = jax.lax.dynamic_update_slice(
            cache_k, kq[i][None], (slot, 0, off, 0)
        )
        cache_v = jax.lax.dynamic_update_slice(
            cache_v, vq[i][None], (slot, 0, off, 0)
        )
        if ks is not None:
            cache_ks = jax.lax.dynamic_update_slice(
                cache_ks, ks[i][None], (slot, 0, off)
            )
            cache_vs = jax.lax.dynamic_update_slice(
                cache_vs, vs[i][None], (slot, 0, off)
            )
        return (cache_k, cache_v, cache_ks, cache_vs), None

    n = slot_ids.shape[0]
    cks0 = cache.k_scale if ks is not None else jnp.zeros((0,), jnp.float32)
    cvs0 = cache.v_scale if ks is not None else jnp.zeros((0,), jnp.float32)
    (ck, cv, cks, cvs), _ = jax.lax.scan(
        write_one, (cache.k, cache.v, cks0, cvs0), jnp.arange(n)
    )
    return KVCache(
        k=ck,
        v=cv,
        lengths=lengths,
        k_scale=cks if cache.k_scale is not None else None,
        v_scale=cvs if cache.v_scale is not None else None,
    )


def free_slots(cache: KVCache, slot_ids: jax.Array) -> KVCache:
    """Mark slots empty (lengths 0); data is left in place and overwritten."""
    return dataclasses.replace(
        cache, lengths=cache.lengths.at[slot_ids].set(0)
    )
