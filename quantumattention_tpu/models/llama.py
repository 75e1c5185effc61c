"""Llama-family transformer built on the fused attention engine.

The reference ships no model code — its README positions it as a drop-in for
``F.scaled_dot_product_attention`` inside user transformers.  This module is
this build's "minimum end-to-end slice" (SURVEY.md §7 step 5): a
Llama-style decoder (RMSNorm → GQA attention with RoPE → SwiGLU MLP) whose
attention is served by ``fp8_attn_func_with_fallback`` /
``attn_func_with_fallback``, demonstrating exactly how a user of the
reference would drop the engine into a real model.

Design notes:
  * pure-functional params pytree — jit/pjit/grad compose freely;
  * all matmuls stay large bf16 einsums on the tensor cores; RoPE/RMSNorm
    are elementwise work XLA fuses around them;
  * every weight is stored transposed-for-einsum so no relayout is needed;
  * sharding is externalized: `parallel.mesh` assigns PartitionSpecs over a
    device mesh, nothing in here mentions devices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from .. import interface
from . import quantized

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_q_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: Any = jnp.bfloat16
    #: "fp8" routes attention through fp8_attn_func_with_fallback (dynamic
    #: head-wise quantization), "bf16" through attn_func_with_fallback,
    #: "sdpa" forces the XLA reference path.
    attention_impl: str = "fp8"
    scaling_method: str = "head-wise"
    #: Optional sliding-window extent (Mistral-style local attention).
    window: Optional[int] = None
    #: Tie input embedding and output head (Llama-3.2 style).
    tie_embeddings: bool = False
    #: Bias on the Q/K/V projections (Qwen2 style).
    qkv_bias: bool = False
    #: Mixture-of-Experts FFN (Mixtral style): 0 = dense SwiGLU; > 0
    #: replaces every MLP with ``models/moe.moe_ffn`` over this many
    #: experts (top-``num_experts_per_tok`` routing, capacity dropping).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25

    @property
    def q_dim(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def llama3_8b(**overrides) -> LlamaConfig:
    """Llama-3-8B shapes (the BASELINE.md decode-benchmark model)."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
        ),
        **overrides,
    )


def llama3_70b(**overrides) -> LlamaConfig:
    """Llama-3-70B shapes (the BASELINE.md multi-host scaling model)."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=128256,
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_q_heads=64,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
        ),
        **overrides,
    )


def mistral_7b(**overrides) -> LlamaConfig:
    """Mistral-7B shapes: Llama architecture + 4096-token sliding window."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=10000.0,
            window=4096,
        ),
        **overrides,
    )


def qwen2_7b(**overrides) -> LlamaConfig:
    """Qwen2-7B shapes: Llama architecture + QKV projection biases."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_layers=28,
            num_q_heads=28,
            num_kv_heads=4,
            head_dim=128,
            rope_theta=1000000.0,
            qkv_bias=True,
        ),
        **overrides,
    )


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """Mixtral-8x7B shapes: Mistral architecture + 8-expert sparse MoE."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1000000.0,
            num_experts=8,
            num_experts_per_tok=2,
        ),
        **overrides,
    )


def tiny(**overrides) -> LlamaConfig:
    """Small config for tests and multi-chip dry runs."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=256,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_q_heads=8,
            num_kv_heads=4,
            head_dim=64,
            rope_theta=10000.0,
        ),
        **overrides,
    )


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_params(key: jax.Array, cfg: LlamaConfig) -> Params:
    """Truncated-normal init, scaled 1/sqrt(fan_in), stored in cfg.dtype."""

    def dense(key, shape):
        fan_in = shape[0]
        w = jax.random.truncated_normal(key, -3, 3, shape, jnp.float32)
        return (w / math.sqrt(fan_in)).astype(cfg.dtype)

    n_keys = 2 + 7 * cfg.num_layers
    keys = iter(jax.random.split(key, n_keys))

    params: Params = {
        "embed": dense(next(keys), (cfg.vocab_size, cfg.hidden_size)),
        "final_norm": jnp.ones((cfg.hidden_size,), jnp.float32),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(next(keys), (cfg.hidden_size, cfg.vocab_size))
    else:
        next(keys)
    for _ in range(cfg.num_layers):
        layer_params = {}
        if cfg.qkv_bias:
            layer_params.update(
                bq=jnp.zeros((cfg.q_dim,), cfg.dtype),
                bk=jnp.zeros((cfg.kv_dim,), cfg.dtype),
                bv=jnp.zeros((cfg.kv_dim,), cfg.dtype),
            )
        layer_params |= {
            "attn_norm": jnp.ones((cfg.hidden_size,), jnp.float32),
            "wq": dense(next(keys), (cfg.hidden_size, cfg.q_dim)),
            "wk": dense(next(keys), (cfg.hidden_size, cfg.kv_dim)),
            "wv": dense(next(keys), (cfg.hidden_size, cfg.kv_dim)),
            "wo": dense(next(keys), (cfg.q_dim, cfg.hidden_size)),
            "mlp_norm": jnp.ones((cfg.hidden_size,), jnp.float32),
        }
        if cfg.num_experts > 0:
            from . import moe as moe_lib

            layer_params["moe"] = moe_lib.init_moe_params(
                next(keys),
                cfg.hidden_size,
                cfg.intermediate_size,
                cfg.num_experts,
                dtype=cfg.dtype,
            )
            next(keys), next(keys)  # keep the per-layer key budget fixed
        else:
            layer_params |= {
                "w_gate": dense(next(keys), (cfg.hidden_size, cfg.intermediate_size)),
                "w_up": dense(next(keys), (cfg.hidden_size, cfg.intermediate_size)),
                "w_down": dense(next(keys), (cfg.intermediate_size, cfg.hidden_size)),
            }
        params["layers"].append(layer_params)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    normed = xf * jax.lax.rsqrt(var + eps)
    return (normed * weight).astype(x.dtype)


def rope_table(
    positions: jax.Array, head_dim: int, theta: float
) -> Tuple[jax.Array, jax.Array]:
    """(..., S) int positions -> cos/sin tables of shape (..., S, head_dim//2)."""
    freqs = 1.0 / (
        theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    )
    angles = positions.astype(jnp.float32)[..., None] * freqs
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Rotate (B, H, S, D) by per-position cos/sin ((B, S, D/2) or (S, D/2)).

    Uses the split-halves convention (rotate_half), matching HF Llama.
    """
    if cos.ndim == 2:  # (S, D/2) -> broadcast over batch and heads
        cos_b = cos[None, None, :, :]
        sin_b = sin[None, None, :, :]
    else:  # (B, S, D/2)
        cos_b = cos[:, None, :, :]
        sin_b = sin[:, None, :, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    out = jnp.concatenate(
        (x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b), axis=-1
    )
    return out.astype(x.dtype)


def _attend(cfg: LlamaConfig, q, k, v, *, is_causal: bool):
    # HF convention: sliding_window=w attends to exactly w keys including
    # self, i.e. left extent w-1.
    window = (cfg.window - 1, 0) if cfg.window is not None else None
    if cfg.attention_impl == "fp8":
        return interface.fp8_attn_func_with_fallback(
            q, k, v, is_causal=is_causal,
            scaling_method=cfg.scaling_method, window=window,
        )
    if cfg.attention_impl == "bf16":
        return interface.attn_func_with_fallback(
            q, k, v, is_causal=is_causal, window=window
        )
    if cfg.attention_impl == "sdpa":
        from ..dispatch import sdpa_fallback

        return sdpa_fallback(q, k, v, is_causal=is_causal, window=window)
    raise ValueError(f"unknown attention_impl: {cfg.attention_impl!r}")


def _split_qkv(cfg: LlamaConfig, layer: Params, qkv: jax.Array):
    """Split a fused [q|k|v] projection and add biases (Qwen2 style)."""
    q, k, v = jnp.split(qkv, [cfg.q_dim, cfg.q_dim + cfg.kv_dim], axis=-1)
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    return q, k, v


def _qkv_proj(cfg: LlamaConfig, layer: Params, h: jax.Array):
    """Q/K/V projections with optional biases (Qwen2 style).

    A tree fused by ``quantized.fuse_projections`` carries one
    ``w_qkv = [wq|wk|wv]`` matrix — one matmul op instead of three (the
    per-op fixed dispatch cost dominates decode steps; see
    quantized.fuse_projections)."""
    if "w_qkv" in layer:
        return _split_qkv(
            cfg, layer, quantized.matmul("bse,ef->bsf", h, layer["w_qkv"])
        )
    q = quantized.matmul("bse,eq->bsq", h, layer["wq"])
    k = quantized.matmul("bse,ek->bsk", h, layer["wk"])
    v = quantized.matmul("bse,ek->bsk", h, layer["wv"])
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    return q, k, v


def _layer_attention(
    cfg: LlamaConfig,
    idx: int,
    layer: Params,
    x: jax.Array,
    cos: jax.Array,
    sin: jax.Array,
    attend_fn,
):
    """One attention sublayer over (B, T, E): norm -> QKV -> RoPE ->
    ``attend_fn(idx, q, k, v)`` on (B, H, T, D) tensors.

    Returns (attn_out, k, v): attn_out is (B, T, q_dim) BEFORE the output
    projection (wo + residual live in ``_layer_tail``); k/v are the
    post-RoPE tensors (for KV caching).
    """
    batch, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv_proj(cfg, layer, h)
    q = q.reshape(batch, t, cfg.num_q_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    k = k.reshape(batch, t, cfg.num_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    v = v.reshape(batch, t, cfg.num_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attend_fn(idx, q, k, v)
    out = out.astype(x.dtype).transpose(0, 2, 1, 3).reshape(batch, t, cfg.q_dim)
    return out, k, v


def _layer_tail(
    cfg: LlamaConfig, layer: Params, x: jax.Array, attn_out: jax.Array
) -> jax.Array:
    """Output projection + residual + MLP sublayer."""
    x = x + quantized.matmul("bsq,qe->bse", attn_out, layer["wo"])
    return mlp_block(cfg, layer, x)


def attention_block(
    cfg: LlamaConfig,
    layer: Params,
    x: jax.Array,
    cos: jax.Array,
    sin: jax.Array,
) -> jax.Array:
    """Self-attention sublayer over (B, S, E) activations (fused kernel)."""
    attn_out, _, _ = _layer_attention(
        cfg, 0, layer, x, cos, sin,
        lambda _i, q, k, v: _attend(cfg, q, k, v, is_causal=True),
    )
    return x + quantized.matmul("bsq,qe->bse", attn_out, layer["wo"])


def mlp_block(cfg: LlamaConfig, layer: Params, x: jax.Array) -> jax.Array:
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    if cfg.num_experts > 0:
        from . import moe as moe_lib

        return x + moe_lib.moe_ffn(
            layer["moe"],
            h,
            num_experts_per_tok=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor,
        )
    if "w_gate_up" in layer:
        # Fused [gate|up] (quantized.fuse_projections): one op, one
        # weight stream, exact same numerics after the split.
        gu = quantized.matmul("bse,ef->bsf", h, layer["w_gate_up"])
        gate, up = jnp.split(gu, 2, axis=-1)
    else:
        gate = quantized.matmul("bse,ei->bsi", h, layer["w_gate"])
        up = quantized.matmul("bse,ei->bsi", h, layer["w_up"])
    act = jax.nn.silu(gate.astype(jnp.float32)).astype(x.dtype) * up
    return x + quantized.matmul("bsi,ie->bse", act, layer["w_down"])


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def _decoder(
    params: Params,
    tokens: jax.Array,
    positions: jax.Array,
    cfg: LlamaConfig,
    attend_fn,
    collect_kv: bool = False,
    last_pos: Optional[jax.Array] = None,
):
    """The shared decoder body: embed -> [attention, MLP] x L -> norm ->
    head.  ``attend_fn(idx, q, k, v)`` serves every attention sublayer;
    with ``collect_kv`` the post-RoPE K/V of each layer are also returned.

    ``last_pos`` ((B,) int32): compute the LM head only at that position
    per row — prefill needs one next-token distribution per request, and
    the full-sequence head is the single biggest prefill matmul (4096
    positions x 128k vocab = 8.4 TFLOP at 8B shapes, all but B rows of it
    thrown away).
    """
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = quantized.embed_lookup(params["embed"], tokens, cfg.dtype)
    kv = []
    for idx, layer in enumerate(params["layers"]):
        attn_out, k, v = _layer_attention(
            cfg, idx, layer, x, cos, sin, attend_fn
        )
        if collect_kv:
            kv.append((k, v))
        x = _layer_tail(cfg, layer, x, attn_out)
    if last_pos is not None:
        x = x[jnp.arange(x.shape[0]), last_pos][:, None, :]  # (B, 1, E)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        logits = quantized.tied_head_matmul(x, params["embed"])
    else:
        logits = quantized.matmul("bse,ev->bsv", x, params["lm_head"])
    logits = logits.astype(jnp.float32)
    return (logits, kv) if collect_kv else logits


def _fused_attend(cfg: LlamaConfig):
    return lambda _i, q, k, v: _attend(cfg, q, k, v, is_causal=True)


def forward(
    params: Params,
    tokens: jax.Array,
    cfg: LlamaConfig,
    *,
    positions: Optional[jax.Array] = None,
) -> jax.Array:
    """(B, S) int32 tokens -> (B, S, vocab) fp32 logits."""
    if positions is None:
        positions = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    return _decoder(params, tokens, positions, cfg, _fused_attend(cfg))


def forward_prefill(
    params: Params,
    tokens: jax.Array,
    cfg: LlamaConfig,
    *,
    positions: Optional[jax.Array] = None,
    last_pos: Optional[jax.Array] = None,
):
    """Prefill forward that also returns per-layer rotated K/V for caching.

    Returns (logits, kv): kv is a list of (k, v) tuples, each
    (B, Hkv, S, D) in cfg.dtype — the exact tensors decode attention must
    see, i.e. *after* RoPE.  With ``last_pos`` ((B,) int32 index of each
    row's final prompt token), logits are (B, vocab) — the LM head runs
    on B rows instead of B*S (see _decoder).
    """
    if positions is None:
        positions = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    logits, kv = _decoder(
        params, tokens, positions, cfg, _fused_attend(cfg),
        collect_kv=True, last_pos=last_pos,
    )
    if last_pos is not None:
        logits = logits[:, 0, :]
    return logits, kv


def forward_chunk(
    params: Params,
    tokens: jax.Array,
    positions: jax.Array,
    cfg: LlamaConfig,
    attend_fn,
):
    """Chunked-prefill forward: a (B, T) token chunk at arbitrary positions.

    ``attend_fn(layer_idx, q, k_new, v_new)`` receives (B, H, T, D)
    post-RoPE tensors and must return the attention output for the chunk
    (typically: fused attention over cache-prefix ++ chunk with
    ``q_offset = chunk start``).  Returns (B, T, vocab) fp32 logits.
    """
    return _decoder(params, tokens, positions, cfg, attend_fn)


def _lean_decode_supported(cfg: LlamaConfig, params: Params) -> bool:
    """May the decode step use the lean 2-D driver (`_forward_decode_lean`)?

    Requires the fused-projection layout (every layer carries ``w_qkv`` so
    the packed-RoPE split is a single reshape), no QKV biases, and a dense
    (non-MoE) FFN.  Numerics are bit-identical to the generic path — same
    fp32 RoPE formula, same op order — this gate is purely structural.
    """
    if cfg.qkv_bias or cfg.num_experts > 0:
        return False
    return all("w_qkv" in layer for layer in params["layers"])


def _forward_decode_lean(params, tokens, positions, cfg, attend_fn):
    """Decode forward specialized to T == 1 (measured: the generic
    per-layer glue — 4-D reshapes/transposes + two separate RoPE
    applications — cost ~3.6 ms of a 25 ms 64-slot step at 8B shapes,
    benchmarks/decode_phase_probe.py).  Activations stay 2-D (B, E);
    RoPE runs ONCE on the packed [q|k] block; no transposes exist at all.
    """
    batch = tokens.shape[0]
    G, Hkv, D = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope_table(positions, D, cfg.rope_theta)  # (B, D/2) each
    cosb = cos[:, None, :]  # (B, 1, D/2) — broadcasts over q+k heads
    sinb = sin[:, None, :]
    x = quantized.embed_lookup(params["embed"], tokens[:, None], cfg.dtype)[
        :, 0
    ]
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        qkv = quantized.matmul("be,ef->bf", h, layer["w_qkv"])
        # Packed rotate-half RoPE over q and k together (split-halves
        # convention, identical formula/order to apply_rope — bit-exact).
        qk = qkv[:, : (G + Hkv) * D].reshape(
            batch, G + Hkv, 2, D // 2
        ).astype(jnp.float32)
        x1, x2 = qk[:, :, 0], qk[:, :, 1]
        r1 = x1 * cosb - x2 * sinb
        r2 = x2 * cosb + x1 * sinb
        qk_rot = jnp.stack([r1, r2], axis=2).reshape(
            batch, G + Hkv, D
        ).astype(cfg.dtype)
        q, k = qk_rot[:, :G], qk_rot[:, G:]
        v = qkv[:, (G + Hkv) * D :].reshape(batch, Hkv, D)
        attn = attend_fn(idx, q, k, v)  # (B, G, D)
        attn_flat = attn.astype(x.dtype).reshape(batch, G * D)
        x = _layer_tail(cfg, layer, x[:, None, :], attn_flat[:, None, :])[:, 0]
    x = rms_norm(x[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        logits = quantized.tied_head_matmul(x, params["embed"])
    else:
        logits = quantized.matmul("bse,ev->bsv", x, params["lm_head"])
    return logits[:, 0, :].astype(jnp.float32)


def forward_decode(
    params: Params,
    tokens: jax.Array,
    positions: jax.Array,
    cfg: LlamaConfig,
    attend_fn,
):
    """One-token decode forward.

    Args:
      tokens: (B,) int32 current tokens (one per cache slot).
      positions: (B,) int32 their positions (== pre-append cache lengths).
      attend_fn: callback (layer_idx, q, k_new, v_new) -> (B, Hq, D)
        attention output; the serving engine uses it to append (k_new, v_new)
        to its KV cache and run the fused decode kernel. q/k_new/v_new are
        (B, H, D) post-RoPE.

    Returns (B, vocab) fp32 logits for the next token.
    """
    if _lean_decode_supported(cfg, params):
        return _forward_decode_lean(params, tokens, positions, cfg, attend_fn)

    def attend_t1(idx, q, k, v):  # (B, H, 1, D) <-> engine's (B, H, D)
        out = attend_fn(idx, q[:, :, 0, :], k[:, :, 0, :], v[:, :, 0, :])
        return out[:, :, None, :]

    logits = _decoder(
        params, tokens[:, None], positions[:, None], cfg, attend_t1
    )
    return logits[:, 0, :]


def loss_fn(params: Params, tokens: jax.Array, cfg: LlamaConfig) -> jax.Array:
    """Next-token cross-entropy over (B, S) tokens."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def train_step(params: Params, tokens: jax.Array, cfg: LlamaConfig, lr: float = 1e-3):
    """One SGD step; returns (new_params, loss).  The multi-chip dry-run
    target: jitting this over a sharded mesh exercises the full forward +
    backward + collective stack."""
    loss, grads = jax.value_and_grad(loss_fn)(params, tokens, cfg)
    new_params = jax.tree_util.tree_map(
        lambda p, g: (p - lr * g.astype(jnp.float32)).astype(p.dtype)
        if g is not None
        else p,
        params,
        grads,
    )
    return new_params, loss
