"""Gradient tests for the differentiable attention wrapper.

The reference has no backward pass at all (forward-only custom ops); training
support is a capability extension of this build.  Gradients are checked
differentially against jax.grad of the fp32 SDPA oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumattention_tpu as qa
from quantumattention_tpu.ops.autodiff import attention_with_vjp, quantize_ste
from quantumattention_tpu.ops.quant import quantize_head_wise
from quantumattention_tpu.ops.sdpa import sdpa_reference


def make_qkv(batch, hq, hkv, sq, skv, d, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (batch, hq, sq, d), jnp.float32)
    k = jax.random.normal(k2, (batch, hkv, skv, d), jnp.float32)
    v = jax.random.normal(k3, (batch, hkv, skv, d), jnp.float32)
    return q, k, v


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("is_causal", [False, True])
def test_grads_match_oracle(is_causal):
    q, k, v = make_qkv(1, 4, 4, 256, 256, 64)

    def loss_fused(q, k, v):
        return jnp.sum(
            attention_with_vjp(
                q, k, v, is_causal=is_causal, block_q=128, block_kv=128
            ).astype(jnp.float32)
            ** 2
        )

    def loss_ref(q, k, v):
        return jnp.sum(
            sdpa_reference(q, k, v, is_causal=is_causal).astype(jnp.float32) ** 2
        )

    g_fused = jax.grad(loss_fused, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for gf, gr, name in zip(g_fused, g_ref, "qkv"):
        assert rel_err(gf, gr) < 2e-2, f"d{name} mismatch"


def test_grads_gqa():
    q, k, v = make_qkv(1, 8, 2, 128, 128, 64)

    def loss(q, k, v):
        return jnp.sum(
            attention_with_vjp(q, k, v, block_q=128, block_kv=128).astype(
                jnp.float32
            )
        )

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    assert gq.shape == q.shape and gk.shape == k.shape and gv.shape == v.shape
    assert np.isfinite(np.asarray(gv)).all()
    # dV of a sum-loss: columns of ones through softmax weights -> rows sum
    # to the number of attending (q-head, q-pos) pairs; just sanity-bound it.
    assert float(jnp.abs(gv).max()) > 0


def test_attn_func_is_differentiable_bf16():
    q, k, v = make_qkv(1, 2, 2, 128, 128, 64)
    q, k, v = (t.astype(jnp.bfloat16) for t in (q, k, v))

    def loss(q):
        return jnp.sum(qa.attn_func(q, k, v, is_causal=True).astype(jnp.float32))

    g = jax.grad(loss)(q)
    assert g.shape == q.shape
    assert np.isfinite(np.asarray(g, np.float32)).all()


def test_quantize_ste_passes_gradient():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 4, 64, 64), jnp.float32)

    def loss(x):
        xq, scale = quantize_ste(quantize_head_wise, x)
        return jnp.sum(xq.astype(jnp.float32) * scale[..., None, None])

    g = jax.grad(loss)(x)
    assert g.shape == x.shape
    assert np.isfinite(np.asarray(g)).all()


def _oracle_grads(q, k, v, **kw):
    """jax.grad of the all-heads-at-once fp32 oracle."""
    return jax.grad(
        lambda q, k, v: jnp.sum(
            sdpa_reference(q, k, v, **kw).astype(jnp.float32) ** 2
        ),
        argnums=(0, 1, 2),
    )(q, k, v)


@pytest.mark.parametrize("is_causal", [False, True])
def test_pallas_bwd_matches_oracle(is_causal):
    """The per-head plain backward (ops/autodiff.oracle_vjp, one head's
    logits live at a time) vs jax.grad of the whole oracle."""
    q, k, v = make_qkv(1, 4, 4, 384, 384, 64, seed=3)

    def loss(q, k, v):
        out = attention_with_vjp(
            q, k, v, is_causal=is_causal, block_q=128, block_kv=128
        )
        return jnp.sum(out.astype(jnp.float32) ** 2)

    g_heads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    g_oracle = _oracle_grads(q, k, v, is_causal=is_causal)
    for gp, go, name in zip(g_heads, g_oracle, "qkv"):
        assert rel_err(gp, go) < 2e-2, f"d{name} mismatch"


def test_pallas_bwd_gqa_window():
    q, k, v = make_qkv(1, 8, 2, 256, 256, 64, seed=4)

    def loss(q, k, v):
        out = attention_with_vjp(
            q, k, v, is_causal=True, window=(96, 0), block_q=128, block_kv=128,
        )
        return jnp.sum(out.astype(jnp.float32) ** 2)

    g_heads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    g_oracle = _oracle_grads(q, k, v, is_causal=True, window=(96, None))
    for gp, go, name in zip(g_heads, g_oracle, "qkv"):
        assert rel_err(gp, go) < 2e-2, f"d{name} mismatch"


def test_pallas_bwd_ragged_seq():
    q, k, v = make_qkv(1, 2, 2, 250, 250, 64, seed=5)

    def loss(q, k, v):
        out = attention_with_vjp(q, k, v, block_q=128, block_kv=128)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    g_heads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    g_oracle = _oracle_grads(q, k, v)
    for gp, go, name in zip(g_heads, g_oracle, "qkv"):
        assert rel_err(gp, go) < 2e-2, f"d{name} mismatch"


def test_fp8_path_is_trainable_ste():
    """The fp8 quantize-in-graph path must be differentiable (STE through
    quantization; backward = oracle VJP)."""
    import quantumattention_tpu as qa

    q, k, v = make_qkv(1, 4, 4, 256, 256, 64)
    q, k, v = (t.astype(jnp.bfloat16) for t in (q, k, v))

    def loss(q, k, v):
        out = qa.fp8_attn_func(q, k, v, is_causal=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ref = jax.grad(
        lambda q, k, v: jnp.sum(
            sdpa_reference(q, k, v, is_causal=True).astype(jnp.float32) ** 2
        ),
        argnums=(0, 1, 2),
    )(q, k, v)
    for g, r, name in zip((gq, gk, gv), ref, "qkv"):
        assert rel_err(g, r) < 1e-1, f"d{name}"  # STE: approximate gradients


def test_fp8_train_step_default_config():
    """train_step with the default attention_impl='fp8' must run."""
    from quantumattention_tpu.models import llama

    cfg = llama.tiny()  # attention_impl defaults to "fp8"
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0, cfg.vocab_size)
    _, loss = llama.train_step(params, tokens, cfg)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("scaling_method", ["head-wise", "per-block"])
def test_fp8_blockwise_bwd_matches_oracle_vjp(scaling_method):
    """The fp8 STE backward — the per-head plain VJP — must give the
    gradient of exact unquantized attention, as jax.grad of the oracle
    does."""
    import quantumattention_tpu as qa

    q, k, v = make_qkv(1, 4, 2, 384, 384, 64, seed=31)
    q, k, v = (t.astype(jnp.bfloat16) for t in (q, k, v))

    def loss(q, k, v):
        out = qa.fp8_attn_func(
            q, k, v, is_causal=True, scaling_method=scaling_method
        )
        return jnp.sum(out.astype(jnp.float32) ** 2)

    g_block = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    # The STE backward differentiates the exact forward at the float
    # inputs, so its upstream gradient comes from the quantized output;
    # compare against the oracle VJP fed the same cotangent.
    out = qa.fp8_attn_func(q, k, v, is_causal=True, scaling_method=scaling_method)
    g = 2.0 * out.astype(jnp.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: sdpa_reference(q, k, v, is_causal=True, out_dtype=v.dtype),
        q, k, v,
    )
    g_oracle = vjp(g.astype(v.dtype))
    for gb, go, name in zip(g_block, g_oracle, "qkv"):
        assert rel_err(gb, go) < 2e-2, f"d{name}"
