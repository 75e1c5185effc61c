"""Cached one-token decode (``llama.forward_decode``) against the full
forward on the same configurations: the decode step's layer tail, fused
projections, quantized weights and cache attention must reproduce the
logits of the last position of ``llama.forward``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.models import llama, quantized
from quantumattention_tpu.ops.sdpa import sdpa_reference


def _rel_rmse(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.sqrt(np.mean((g - w) ** 2)) / (np.std(w) + 1e-9))


def _params(cfg, weights, key):
    if weights == "full":
        return llama.init_params(key, cfg)
    tree = quantized.init_quantized_params(key, cfg, int4=weights.startswith("int4"))
    return quantized.fuse_projections(tree) if weights.endswith("fused") else tree


CASES = {
    "f32": (dict(dtype=jnp.float32), "full", 1e-4),
    "bf16": (dict(dtype=jnp.bfloat16), "full", 2e-2),
    "int8": (dict(dtype=jnp.float32), "int8", 1e-4),
    "int8-fused": (dict(dtype=jnp.float32), "int8-fused", 1e-4),
    "int4-fused": (
        dict(dtype=jnp.float32, hidden_size=256, intermediate_size=512,
             num_q_heads=4, num_kv_heads=2, head_dim=128),
        "int4-fused", 1e-4,
    ),
    "qkv-bias": (dict(dtype=jnp.float32, qkv_bias=True), "full", 1e-4),
    "window": (dict(dtype=jnp.float32, window=8), "full", 1e-4),
    "tied": (dict(dtype=jnp.float32, tie_embeddings=True), "full", 1e-4),
    "moe": (dict(dtype=jnp.float32, num_experts=4, capacity_factor=4.0),
            "full", 1e-4),
    "gqa-4": (dict(dtype=jnp.float32, num_q_heads=8, num_kv_heads=2), "full", 1e-4),
    "bf16-int8-fused": (dict(dtype=jnp.bfloat16), "int8-fused", 2e-2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_decode_matches_forward(name):
    overrides, weights, tol = CASES[name]
    cfg = llama.tiny(attention_impl="sdpa", **overrides)
    params = _params(cfg, weights, jax.random.PRNGKey(0))
    batch, seq = 2, 16
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), (batch, seq), 0, cfg.vocab_size
    )
    want = llama.forward(params, tokens, cfg)[:, -1]

    _, kv = llama.forward_prefill(params, tokens[:, :-1], cfg)

    def attend(idx, q, k_new, v_new):
        k_cache, v_cache = kv[idx]
        k = jnp.concatenate([k_cache, k_new[:, :, None]], axis=2)
        v = jnp.concatenate([v_cache, v_new[:, :, None]], axis=2)
        if cfg.window is not None:
            k, v = k[:, :, -cfg.window:], v[:, :, -cfg.window:]
        return sdpa_reference(q[:, :, None], k, v)[:, :, 0]

    positions = jnp.full((batch,), seq - 1, jnp.int32)
    got = llama.forward_decode(params, tokens[:, -1], positions, cfg, attend)
    assert got.shape == (batch, cfg.vocab_size)
    assert _rel_rmse(got, want) < tol, name
