"""Weight-only int8 quantization (w8a16) for the decoder parameter tree.

Beyond the reference (an attention kernel library — SURVEY.md §0).
Decode is weight-bandwidth bound at batch 1-64, so halving weight bytes
also halves the non-attention HBM traffic per token.

Scheme: symmetric per-output-channel scales (reduce |w| over the
contracted input axis), bf16 compute — the standard w8a16 recipe.  A
quantized matrix is ``{"q": int8 (…, in, out), "s": fp32 (…, 1, out)}``;
``matmul()`` consumes either representation so every projection site in
``models/llama.py`` / ``models/moe.py`` works with mixed trees.  The
int8->bf16 convert is the XLA dot's operand prologue.

Inference-only: int8 leaves are not differentiable — ``train_step`` on a
quantized tree fails loudly (use the full-precision tree + the fp8/STE
attention path for QAT).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

#: Keys holding (…, in, out) projection matrices, quantized per-output-
#: channel.  Norms and biases stay full precision (tiny, accuracy-critical).
_MATRIX_KEYS = frozenset(
    ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"]
)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_quantized4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w and "s" in w


#: w4a16 scale-group size along the input (contraction) axis — the
#: standard group-wise int4 recipe (per-output-channel int4 alone is too
#: lossy; 128-row groups bound the error like GPTQ/AWQ defaults).
INT4_GROUP = 128
#: Packing block: rows pair split-halves WITHIN each 256-row block
#: (byte row r of block g holds original rows 256g+r low / 256g+128+r
#: high), so any row tile that is a multiple of 128 packed rows covers a
#: contiguous original-row range.
_PACK_BLOCK = 2 * INT4_GROUP


def pack_int4_rows(q: jax.Array) -> jax.Array:
    """(R, C) int4-range int8 -> (R/2, C) packed (see _PACK_BLOCK)."""
    r, c = q.shape
    if r % _PACK_BLOCK:
        raise ValueError(f"rows ({r}) must be a multiple of {_PACK_BLOCK}")
    g = q.reshape(r // _PACK_BLOCK, _PACK_BLOCK, c).astype(jnp.int32)
    lo, hi = g[:, :INT4_GROUP], g[:, INT4_GROUP:]
    return ((hi << 4) | (lo & 0xF)).astype(jnp.int8).reshape(r // 2, c)


def unpack_int4_rows(packed: jax.Array, out_dtype=jnp.int8) -> jax.Array:
    """Inverse of :func:`pack_int4_rows` for any row extent that is a
    multiple of 128 packed rows (tiles included)."""
    r2, c = packed.shape
    g = packed.astype(jnp.int32).reshape(r2 // INT4_GROUP, INT4_GROUP, c)
    lo = (g << 28) >> 28
    hi = g >> 4  # byte sign == high-nibble sign
    return (
        jnp.concatenate([lo, hi], axis=1).reshape(r2 * 2, c).astype(out_dtype)
    )


def quantize_matrix_int4(w: jax.Array) -> Dict[str, jax.Array]:
    """(in, out) float -> {"q4": (in/2, out) packed int8,
    "s": (in/INT4_GROUP, out) fp32} — symmetric group-wise int4."""
    wf = w.astype(jnp.float32)
    r, c = wf.shape
    if r % _PACK_BLOCK:
        raise ValueError(
            f"int4 quantization needs in-dim % {_PACK_BLOCK} == 0 (got {r})"
        )
    g = wf.reshape(r // INT4_GROUP, INT4_GROUP, c)
    amax = jnp.maximum(jnp.max(jnp.abs(g), axis=1, keepdims=True), 1e-12)
    s = amax / 7.0
    q = jnp.clip(jnp.round(g / s), -8, 7).reshape(r, c).astype(jnp.int8)
    return {"q4": pack_int4_rows(q), "s": s[:, 0, :]}


def dequantize_int4(w: Dict[str, jax.Array], dtype=jnp.float32) -> jax.Array:
    """{"q4", "s"} -> the (in, out) dequantized matrix (reference path for
    tests and the int4 matmul)."""
    u = unpack_int4_rows(w["q4"], jnp.int8).astype(jnp.float32)
    r, c = u.shape
    u = u.reshape(r // INT4_GROUP, INT4_GROUP, c) * w["s"][:, None, :]
    return u.reshape(r, c).astype(dtype)


def quantize_matrix(w: jax.Array) -> Dict[str, jax.Array]:
    """(…, in, out) float -> {"q": int8, "s": (…, 1, out) fp32}."""
    wf = w.astype(jnp.float32)
    amax = jnp.maximum(
        jnp.max(jnp.abs(wf), axis=-2, keepdims=True), 1e-12
    )
    s = amax / 127.0
    q = jnp.round(wf / s).astype(jnp.int8)
    return {"q": q, "s": s}


def matmul(spec: str, x: jax.Array, w: Any) -> jax.Array:
    """``einsum(spec, x, w)`` where ``w`` may be quantized.

    The weights are dequantized first — int8 codes times their (…, 1, out)
    per-output-channel scales, cast to ``x.dtype`` — so the dot only ever
    sees weights at their true magnitude; XLA's GPU GEMM fusion takes the
    convert as the dot's operand prologue.  (Scaling the product instead
    produced NaN logits at Llama-3-8B widths on an H200.)  A w4a16
    ({"q4", "s"}) matrix is unpacked and dequantized the same way.
    """
    if is_quantized4(w):
        return jnp.einsum(spec, x, dequantize_int4(w, x.dtype))
    if is_quantized(w):
        w = (w["q"].astype(jnp.float32) * w["s"]).astype(x.dtype)
    return jnp.einsum(spec, x, w)


def embed_lookup(embed: Any, tokens: jax.Array, dtype) -> jax.Array:
    """Token embedding lookup over a full or row-quantized table."""
    if not is_quantized(embed):
        return embed[tokens].astype(dtype)
    rows = embed["q"][tokens].astype(jnp.float32)
    return (rows * embed["s"][tokens]).astype(dtype)


def quantize_embed(embed: jax.Array) -> Dict[str, jax.Array]:
    """(V, H) float -> {"q": int8, "s": (V, 1) fp32} per-row scales.

    Row scales serve both the lookup and (for tied embeddings) the output
    head, where the row IS the output channel.
    """
    ef = embed.astype(jnp.float32)
    amax = jnp.maximum(jnp.max(jnp.abs(ef), axis=-1, keepdims=True), 1e-12)
    s = amax / 127.0
    return {"q": jnp.round(ef / s).astype(jnp.int8), "s": s}


def tied_head_matmul(x: jax.Array, embed: Any) -> jax.Array:
    """logits = x @ embed.T for a full or row-quantized embedding table."""
    if not is_quantized(embed):
        return jnp.einsum("bse,ve->bsv", x, embed)
    table = (embed["q"].astype(jnp.float32) * embed["s"]).astype(x.dtype)
    return jnp.einsum(
        "bse,ve->bsv", x, table, preferred_element_type=jnp.float32
    )


@functools.partial(jax.jit, static_argnums=(1, 2))
def _init_qdense(key: jax.Array, shape, dtype) -> Dict[str, jax.Array]:
    """One projection matrix, initialized AND quantized inside one jit so
    the full-precision draw is a transient XLA temporary, never a live
    buffer — peak extra HBM is one matrix, not the whole bf16 tree."""
    fan_in = shape[0]
    w = jax.random.truncated_normal(key, -3, 3, shape, jnp.float32)
    return quantize_matrix((w / math.sqrt(fan_in)).astype(dtype))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _init_qdense4(key: jax.Array, shape, dtype) -> Dict[str, jax.Array]:
    fan_in = shape[0]
    w = jax.random.truncated_normal(key, -3, 3, shape, jnp.float32)
    return quantize_matrix_int4((w / math.sqrt(fan_in)).astype(dtype))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _init_qembed(key: jax.Array, shape, dtype) -> Dict[str, jax.Array]:
    fan_in = shape[0]
    w = jax.random.truncated_normal(key, -3, 3, shape, jnp.float32)
    return quantize_embed((w / math.sqrt(fan_in)).astype(dtype))


def init_quantized_params(key: jax.Array, cfg, int4: bool = False) -> Params:
    """``quantize_params(llama.init_params(key, cfg))`` without ever
    materializing the full-precision tree.

    Peak extra device memory is one full-precision matrix.  Key schedule
    and init math replicate
    ``models/llama.init_params`` exactly; the resulting tree matches
    quantizing the full-precision init up to jit-vs-eager fp rounding
    (tested to 1e-5 relative).

    ``int4=True``: decoder projections become w4a16 group-wise int4
    (half the weight bytes again).  Embedding and lm_head stay int8;
    MoE expert stacks stay int8 (the 3-D einsum path)."""
    dense = _init_qdense4 if int4 else _init_qdense
    n_keys = 2 + 7 * cfg.num_layers
    keys = iter(jax.random.split(key, n_keys))
    dt = cfg.dtype

    params: Params = {
        "embed": _init_qembed(next(keys), (cfg.vocab_size, cfg.hidden_size), dt),
        "final_norm": jnp.ones((cfg.hidden_size,), jnp.float32),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _init_qdense(
            next(keys), (cfg.hidden_size, cfg.vocab_size), dt
        )
    else:
        next(keys)
    for _ in range(cfg.num_layers):
        layer: Params = {}
        if cfg.qkv_bias:
            layer.update(
                bq=jnp.zeros((cfg.q_dim,), dt),
                bk=jnp.zeros((cfg.kv_dim,), dt),
                bv=jnp.zeros((cfg.kv_dim,), dt),
            )
        layer |= {
            "attn_norm": jnp.ones((cfg.hidden_size,), jnp.float32),
            "wq": dense(next(keys), (cfg.hidden_size, cfg.q_dim), dt),
            "wk": dense(next(keys), (cfg.hidden_size, cfg.kv_dim), dt),
            "wv": dense(next(keys), (cfg.hidden_size, cfg.kv_dim), dt),
            "wo": dense(next(keys), (cfg.q_dim, cfg.hidden_size), dt),
            "mlp_norm": jnp.ones((cfg.hidden_size,), jnp.float32),
        }
        if cfg.num_experts > 0:
            from . import moe as moe_lib

            moe_params = moe_lib.init_moe_params(
                next(keys), cfg.hidden_size, cfg.intermediate_size,
                cfg.num_experts, dtype=dt,
            )
            for k in ("w_gate", "w_up", "w_down"):
                moe_params[k] = jax.jit(quantize_matrix)(moe_params[k])
            layer["moe"] = moe_params  # router stays fp32
            next(keys), next(keys)
        else:
            layer |= {
                "w_gate": dense(
                    next(keys), (cfg.hidden_size, cfg.intermediate_size), dt
                ),
                "w_up": dense(
                    next(keys), (cfg.hidden_size, cfg.intermediate_size), dt
                ),
                "w_down": dense(
                    next(keys), (cfg.intermediate_size, cfg.hidden_size), dt
                ),
            }
        params["layers"].append(layer)
    return params


def _concat_quantized(parts) -> Dict[str, jax.Array]:
    """Concatenate quantized matrices along the OUTPUT (last) axis —
    per-output-channel (and per-group) scales concatenate right along.
    Works for both int8 ({"q", "s"}) and int4 ({"q4", "s"}) parts (the
    packing axis is the input axis, untouched by an output concat)."""
    key = "q4" if is_quantized4(parts[0]) else "q"
    if any(("q4" in p) != (key == "q4") for p in parts):
        raise ValueError("cannot fuse mixed int8/int4 projections")
    return {
        key: jnp.concatenate([p[key] for p in parts], axis=-1),
        "s": jnp.concatenate([p["s"] for p in parts], axis=-1),
    }


def fuse_projections(params: Params) -> Params:
    """Fuse per-layer QKV and gate/up projections into single matrices.

    Serving optimization for single-card engines: fusing [wq|wk|wv] ->
    w_qkv and [w_gate|w_up] -> w_gate_up removes 3 matmul ops per layer
    and doubles the bytes per remaining op.
    Numerics are EXACTLY the einsum's: per-output-channel scales
    concatenate along the fused axis.

    Tensor-parallel serving must NOT fuse: the tp column shard of a
    concatenated [gate|up] puts all-gate halves on chip 0 (parallel/
    mesh.param_specs_for rejects fused trees).  Works on quantized trees
    (the w8a16 serving representation); biases stay separate (added after
    the split).
    """

    def _q(w: Any) -> bool:
        return is_quantized(w) or is_quantized4(w)

    def one_layer(layer: Params) -> Params:
        out = dict(layer)
        if all(k in out and _q(out[k]) for k in ("wq", "wk", "wv")):
            out["w_qkv"] = _concat_quantized(
                [out.pop("wq"), out.pop("wk"), out.pop("wv")]
            )
        if all(k in out and _q(out[k]) for k in ("w_gate", "w_up")):
            out["w_gate_up"] = _concat_quantized(
                [out.pop("w_gate"), out.pop("w_up")]
            )
        return out

    out = dict(params)
    out["layers"] = [one_layer(l) for l in params["layers"]]
    return out


def quantize_params_int4(params: Params) -> Params:
    """Quantize a full-precision tree's decoder projections to group-wise
    int4 (``quantize_matrix_int4``); embedding stays per-row int8 (lookup
    path), lm_head int8, MoE expert stacks int8 (3-D
    einsum path).  Matrices whose input dim is not a multiple of 256
    (packing blocks) fall back to int8."""

    def qmat4(w: jax.Array) -> Dict[str, jax.Array]:
        if w.ndim == 2 and w.shape[0] % _PACK_BLOCK == 0:
            return quantize_matrix_int4(w)
        return quantize_matrix(w)

    def one_layer(layer: Params) -> Params:
        out = dict(layer)
        for k in _MATRIX_KEYS:
            if k in out and not (is_quantized(out[k]) or is_quantized4(out[k])):
                out[k] = qmat4(out[k])
        if "moe" in out:
            moe = dict(out["moe"])
            for k in ("w_gate", "w_up", "w_down"):
                moe[k] = quantize_matrix(moe[k])
            out["moe"] = moe
        return out

    out: Params = {
        "embed": quantize_embed(params["embed"]),
        "final_norm": params["final_norm"],
        "layers": [one_layer(l) for l in params["layers"]],
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_matrix(params["lm_head"])
    return out


def quantize_params(params: Params) -> Params:
    """Quantize every projection matrix in a ``models/llama.init_params``
    tree (embed per-row; norms/biases/router untouched)."""

    def one_layer(layer: Params) -> Params:
        out = dict(layer)
        for k in _MATRIX_KEYS:
            if k in out and not is_quantized(out[k]):
                out[k] = quantize_matrix(out[k])
        if "moe" in out:
            moe = dict(out["moe"])
            for k in ("w_gate", "w_up", "w_down"):
                moe[k] = quantize_matrix(moe[k])
            out["moe"] = moe  # router stays fp32
        return out

    out: Params = {
        "embed": quantize_embed(params["embed"]),
        "final_norm": params["final_norm"],
        "layers": [one_layer(l) for l in params["layers"]],
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_matrix(params["lm_head"])
    return out
