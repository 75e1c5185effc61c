"""Paged decode attention: KV in a pool of fixed-size pages.

The serving engine's contiguous slot cache (ops/decode.py) reserves
max_len per slot; the paged layout removes that: KV lives in a global pool
of fixed-size pages and each sequence owns an arbitrary page list — the
vLLM-style layout (absent from the reference, which has no decode path at
all — SURVEY.md §0).

Each sequence's pages are gathered through its page table into a
contiguous cache (plain XLA), then the same decode attention as the slots
backend runs over it (``ops/decode.decode_attention``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils import checks
from . import quant as quant_ops
from .decode import MASK_VALUE, decode_attention  # noqa: F401 (MASK_VALUE: side-mask fill)


def _gather_and_attend(
    q, k_pages, v_pages, lengths, page_indices, *,
    k_scale_pages, v_scale_pages, sm_scale, interpret, window=None,
    int4=False, side=None,
):
    """Materialize each sequence's pages contiguously, then run the ragged
    decode attention.  With a ``side`` buffer the side tokens are spliced
    in after each sequence's cache prefix (side-valid columns are a PREFIX
    of the buffer by the burst contract, so they map to consecutive rows
    at ``lengths[b]``) and the effective lengths grow by the per-slot
    valid side count.  Slots with an empty cache prefix return zeros."""
    if int4:
        # Unpack the token-packed pages to int4-range int8 values first so
        # the per-page split-halves order becomes natural token order; the
        # ragged kernel's int8 path dequantizes them (value * scale holds
        # for any integer range).
        k_pages = quant_ops.unpack_int4(k_pages, jnp.int8, axis=2)
        v_pages = quant_ops.unpack_int4(v_pages, jnp.int8, axis=2)

    def gather(pages, table):  # (Hkv, P, ps, ...) x (pps,) -> (Hkv, pps*ps, ...)
        g = jnp.take(pages, table, axis=1)
        return g.reshape((g.shape[0], -1) + g.shape[3:])

    k_seq = jax.vmap(lambda t: gather(k_pages, t))(page_indices)
    v_seq = jax.vmap(lambda t: gather(v_pages, t))(page_indices)
    ks = vs = None
    if k_scale_pages is not None:
        def gather_scale(pages, table):
            # Either scale layout ((Hkv, P, ps) or the folded
            # (Hkv, P, ps/128, 128)) flattens to (Hkv, tokens).
            g = jnp.take(pages, table, axis=1)
            return g.reshape(g.shape[0], -1)

        ks = jax.vmap(lambda t: gather_scale(k_scale_pages, t))(page_indices)
        vs = jax.vmap(lambda t: gather_scale(v_scale_pages, t))(page_indices)
    if side is not None:
        tpad = side["k"].shape[2]
        pad4 = [(0, 0), (0, 0), (0, tpad), (0, 0)]
        k_seq = jnp.pad(k_seq, pad4)
        v_seq = jnp.pad(v_seq, pad4)
        dus4 = jax.vmap(
            lambda seq, sd, off: jax.lax.dynamic_update_slice(
                seq, sd, (0, off, 0)
            )
        )
        k_seq = dus4(k_seq, side["k"].astype(k_seq.dtype), lengths)
        v_seq = dus4(v_seq, side["v"].astype(v_seq.dtype), lengths)
        if ks is not None:
            pad3 = [(0, 0), (0, 0), (0, tpad)]
            ks = jnp.pad(ks, pad3)
            vs = jnp.pad(vs, pad3)
            dus3 = jax.vmap(
                lambda s, sd, off: jax.lax.dynamic_update_slice(
                    s, sd, (0, off)
                )
            )
            ks = dus3(ks, side["ks"].astype(ks.dtype), lengths)
            vs = dus3(vs, side["vs"].astype(vs.dtype), lengths)
        n_side = jnp.sum(side["mask"] == 0.0, axis=-1).astype(jnp.int32)
        out = decode_attention(
            q, k_seq, v_seq, lengths + n_side,
            k_scale=ks, v_scale=vs, sm_scale=sm_scale, window=window,
            interpret=interpret,
        )
        empty = (lengths == 0).reshape((-1,) + (1,) * (out.ndim - 1))
        return jnp.where(empty, jnp.zeros_like(out), out)
    return decode_attention(
        q, k_seq, v_seq, lengths,
        k_scale=ks, v_scale=vs, sm_scale=sm_scale, window=window,
        interpret=interpret,
    )


def paged_decode_attention(
    q: jax.Array,
    k_pages: jax.Array,
    v_pages: jax.Array,
    lengths: jax.Array,
    page_indices: jax.Array,
    *,
    k_scale_pages: Optional[jax.Array] = None,
    v_scale_pages: Optional[jax.Array] = None,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    interpret: Optional[bool] = None,
    side: Optional[dict] = None,
) -> jax.Array:
    """Decode attention over paged KV; returns (B, Hq, D) bf16.

    Args:
      q: (B, Hq, D) float (bf16/fp16/fp32) — or (B, Hq, T, D) for
        multi-query verification (speculative decoding): ``lengths`` must
        already INCLUDE the T appended candidates and token t attends to
        everything before the candidates plus candidates 0..t
        (intra-chunk causal; same contract as ops/decode.decode_attention).
      k_pages/v_pages: (Hkv, num_pages, page_size, D).
      lengths: (B,) int32 valid token counts.
      page_indices: (B, pages_per_seq) int32 page table (entries beyond the
        sequence's pages are ignored; must still be < num_pages).
      k_scale_pages/v_scale_pages: per-token fp32 scales for 8-bit
        pages — (Hkv, num_pages, page_size), or the folded
        (Hkv, num_pages, page_size/128, 128) layout for pages wider than
        128 tokens (serving/paged_cache.scale_shape).
      side: optional burst side buffer — this burst's appended tokens,
        attended AFTER each sequence's cache prefix so the page pool can
        stay scan-invariant for a whole decode burst:
        {"k"/"v": (B, Hkv, Tpad, D) in the page container dtype,
        "ks"/"vs": (B, Hkv, Tpad) f32 per-token scales (required iff the
        pages are quantized), "mask": (B, Tpad) f32 additive validity
        {0, MASK}}.  Tpad must be a multiple of 8.  Side-valid columns
        must be a prefix per slot; ``lengths`` counts the CACHE prefix
        only.  Slots with length 0 return zeros even if side columns are
        valid (the serving engine never bursts an unprefilled slot).
        Unsupported with int4 pages, multi-query q, or sliding window.
    """
    if q.ndim == 4:
        batch, num_q_heads, q_tokens, head_dim = q.shape
    else:
        batch, num_q_heads, head_dim = q.shape
        q_tokens = 1
    num_kv_heads, _, page_rows, _ = k_pages.shape
    if num_q_heads % num_kv_heads != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    quantized = k_scale_pages is not None
    if quantized != (v_scale_pages is not None):
        raise ValueError("k_scale_pages and v_scale_pages go together")
    if checks.is_8bit_dtype(k_pages.dtype) and not quantized:
        raise ValueError("8-bit KV pages require scale pages")
    # Token-packed int4 pages (serving/paged_cache.init_layer_pages): half
    # the byte rows per page, per-REAL-token scales.  Detected from the
    # scale extent — int4 always carries scales.  Any other extent is a
    # malformed scale array, not a layout: raise rather than silently
    # reinterpreting int8 pages as int4 (or computing a wrong page_size).
    int4 = False
    if quantized:
        def _rows(sp):
            if sp.ndim == 4:
                if sp.shape[3] != 128:
                    raise ValueError(
                        f"folded scale pages must have a 128-lane minor, "
                        f"got {sp.shape}"
                    )
                return sp.shape[2] * sp.shape[3]
            return sp.shape[2]

        scale_rows = _rows(k_scale_pages)
        if scale_rows == 2 * page_rows:
            int4 = True
        elif scale_rows != page_rows:
            raise ValueError(
                f"scale pages carry {scale_rows} token rows per page, but "
                f"the KV pages have {page_rows} byte rows: expected exactly "
                f"{page_rows} (int8 layout) or {2 * page_rows} (token-packed "
                "int4 layout)"
            )
        if _rows(v_scale_pages) != scale_rows or (
            v_scale_pages.ndim != k_scale_pages.ndim
        ):
            raise ValueError(
                f"k/v scale pages disagree on layout: "
                f"{k_scale_pages.shape} vs {v_scale_pages.shape}"
            )
    if int4 and k_pages.dtype != jnp.int8:
        raise ValueError("int4 pages must use an int8 container")
    if window is not None and window[1] not in (None, 0):
        raise ValueError(
            "paged_decode_attention window must be (left, 0) or (left, None): "
            f"queries are the newest tokens, got right={window[1]}"
        )
    if side is not None:
        if q_tokens != 1:
            raise ValueError("side buffer requires single-token queries")
        if int4:
            raise ValueError("side buffer unsupported with int4 pages")
        if window is not None and window[0] is not None:
            raise ValueError("side buffer unsupported with sliding window")
        sb, shkv, tpad, sd = side["k"].shape
        if (sb, shkv, sd) != (batch, num_kv_heads, head_dim) or tpad % 8:
            raise ValueError(
                f"side buffer shape {side['k'].shape} does not match "
                f"(B={batch}, Hkv={num_kv_heads}, Tpad%8==0, D={head_dim})"
            )
        if quantized != (side.get("ks") is not None):
            raise ValueError(
                "side scales must be present iff the pages are quantized"
            )
    return _gather_and_attend(
        q, k_pages, v_pages, lengths, page_indices,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
        sm_scale=sm_scale, window=window, interpret=interpret,
        int4=int4, side=side,
    )
