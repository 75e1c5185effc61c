"""Tensor-parallel serving: head-sharded attention + parameter/cache
placement for the continuous-batching engine.

The reference is single-GPU (SURVEY.md §2.3 — zero distributed code); this
serves models larger than one card.  The recipe:

  * weights Megatron-sharded over a ``tp`` mesh axis via GSPMD
    (``parallel/mesh.llama_param_specs`` col/row splits — XLA inserts the
    all-gather/psum collectives around the einsums);
  * KV caches sharded on the KV-head axis (each chip owns whole GQA
    groups, so cache append and decode attention are zero-communication);
  * the Pallas attention kernels wrapped in ``shard_map`` — under plain
    jit a ``pallas_call`` is opaque to GSPMD and its sharded operands
    would be all-gathered onto every chip (same reasoning as
    ``parallel/tp.head_parallel_attention``); the wrapper runs the fused
    kernel on each chip's local heads instead.

Per-card HBM at Llama-3-70B shapes: 140 GB of bf16 weights / tp=4 = 35 GB
+ the KV-head shard of the cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import llama
from ..ops.decode import decode_attention
from . import kv_cache as kvc


def shard_serving_params(
    params: llama.Params, cfg: llama.LlamaConfig, mesh: Mesh
) -> llama.Params:
    """Place a (full-precision or w8a16-quantized) param tree onto the
    mesh with the Megatron col/row layout."""
    from ..parallel import mesh as qmesh

    return qmesh.shard_params(
        params, mesh, qmesh.param_specs_for(params, cfg)
    )


def shard_cache(cache: kvc.KVCache, mesh: Mesh, axis: str = "tp") -> kvc.KVCache:
    """Shard a slot KV cache on its KV-head dim; lengths replicated."""
    ns = lambda spec: NamedSharding(mesh, spec)
    put = lambda x, spec: jax.device_put(x, ns(spec))
    return dataclasses.replace(
        cache,
        k=put(cache.k, P(None, axis, None, None)),
        v=put(cache.v, P(None, axis, None, None)),
        lengths=put(cache.lengths, P()),
        k_scale=(
            put(cache.k_scale, P(None, axis, None))
            if cache.k_scale is not None else None
        ),
        v_scale=(
            put(cache.v_scale, P(None, axis, None))
            if cache.v_scale is not None else None
        ),
    )


def decode_attention_tp(
    q: jax.Array,
    k_cache: jax.Array,
    v_cache: jax.Array,
    lengths: jax.Array,
    *,
    mesh: Mesh,
    axis: str = "tp",
    k_scale: Optional[jax.Array] = None,
    v_scale: Optional[jax.Array] = None,
    block_kv: Optional[int] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> jax.Array:
    """``ops/decode.decode_attention`` with heads sharded over
    ``mesh[axis]``: each chip runs the ragged GQA decode kernel on its
    local Q-head groups and their co-located KV heads — zero communication
    (heads are independent in attention; the psum lives in the row-sharded
    output projection that follows)."""
    if q.ndim != 3:
        raise ValueError(
            "decode_attention_tp takes (B, Hq, D) single-token queries "
            f"(got ndim={q.ndim}); multi-query verification is a "
            "single-chip path"
        )
    n = mesh.shape[axis]
    num_q_heads, num_kv_heads = q.shape[1], k_cache.shape[1]
    if num_q_heads % n or num_kv_heads % n:
        raise ValueError(
            f"q heads ({num_q_heads}) and kv heads ({num_kv_heads}) must "
            f"be divisible by the '{axis}' axis size ({n})"
        )

    hq = P(None, axis, None)
    hkv = P(None, axis, None, None)
    sc = P(None, axis, None)
    quantized = k_scale is not None

    def body(q, ck, cv, lens, *scales):
        ks, vs = scales if quantized else (None, None)
        return decode_attention(
            q, ck, cv, lens,
            k_scale=ks, v_scale=vs, block_kv=block_kv, window=window,
        )

    in_specs = [hq, hkv, hkv, P()]
    args = [q, k_cache, v_cache, lengths]
    if quantized:
        in_specs += [sc, sc]
        args += [k_scale, v_scale]
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=hq,
        check_vma=False,
    )(*args)


def chunk_attention_tp(
    q: jax.Array,
    k_new: jax.Array,
    v_new: jax.Array,
    cache: kvc.KVCache,
    slot: jax.Array,
    off: int,
    *,
    mesh: Mesh,
    axis: str = "tp",
    head_dim: int,
    window=None,
) -> jax.Array:
    """Chunked-prefill attention (cache prefix + chunk) with heads sharded
    over ``mesh[axis]`` — the mesh engine's mixed prefill/decode building
    block.  Each chip gathers ITS KV-head shard of the slot's cache prefix
    and runs the fused causal kernel on its local Q-head groups; like
    ``decode_attention_tp``, attention itself is zero-communication (the
    psum lives in the row-sharded output projection that follows)."""
    from .backends import _chunk_prefix_attend

    n = mesh.shape[axis]
    if q.shape[1] % n or k_new.shape[1] % n:
        raise ValueError(
            f"q heads ({q.shape[1]}) and kv heads ({k_new.shape[1]}) must "
            f"be divisible by the '{axis}' axis size ({n})"
        )
    h4 = P(None, axis, None, None)
    sc = P(None, axis, None)
    quantized = cache.k_scale is not None

    def body(q, kn, vn, ck, cv, slot, *scales):
        ks, vs = scales if quantized else (None, None)
        return _chunk_prefix_attend(
            q, kn, vn, ck, cv, ks, vs, slot, off,
            head_dim=head_dim, window=window,
        )

    in_specs = [h4, h4, h4, h4, h4, P()]
    args = [q, k_new, v_new, cache.k, cache.v, slot]
    if quantized:
        in_specs += [sc, sc]
        args += [cache.k_scale, cache.v_scale]
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=h4,
        check_vma=False,
    )(*args)


def prefill_attend(cfg: llama.LlamaConfig, mesh: Mesh, axis: str = "tp"):
    """attend_fn for ``models/llama._decoder``: the config's fused prefill
    attention (fp8/bf16/sdpa) shard_mapped over local heads."""
    hspec = P(None, axis, None, None)

    def attend(_i, q, k, v):
        def body(q, k, v):
            return llama._attend(cfg, q, k, v, is_causal=True)

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(hspec, hspec, hspec),
            out_specs=hspec,
            check_vma=False,
        )(q, k, v)

    return attend


def forward_prefill_tp(
    params: llama.Params,
    tokens: jax.Array,
    *,
    cfg: llama.LlamaConfig,
    mesh: Mesh,
    axis: str = "tp",
    last_pos: Optional[jax.Array] = None,
):
    """``models/llama.forward_prefill`` with head-sharded fused attention
    (same signature contract: returns (logits, per-layer post-RoPE K/V);
    ``last_pos`` restricts the LM head to one row per request)."""
    positions = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    logits, kv = llama._decoder(
        params, tokens, positions, cfg,
        prefill_attend(cfg, mesh, axis), collect_kv=True, last_pos=last_pos,
    )
    if last_pos is not None:
        logits = logits[:, 0, :]
    return logits, kv
