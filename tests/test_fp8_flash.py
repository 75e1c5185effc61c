"""FP8/int8 fused-attention differential tests.

The numerical-semantics oracle is dequantize-then-SDPA, exactly as the
reference defines its FP8 op (reference: src/quantum_attn/ops.py:64-95);
accuracy bar RMSE < 1e-2 vs the *unquantized* fp32 oracle, matching
tests/test_interface.py:57-59 at the same 8-bit width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.ops import quant
from quantumattention_tpu.ops.flash import flash_attention
from quantumattention_tpu.ops.sdpa import sdpa_reference

RMSE_TOL = 1e-2


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def make_qkv(batch, hq, hkv, sq, skv, d, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (batch, hq, sq, d), jnp.float32)
    k = jax.random.normal(k2, (batch, hkv, skv, d), jnp.float32)
    v = jax.random.normal(k3, (batch, hkv, skv, d), jnp.float32)
    return q, k, v


@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize("scaling", ["head", "token"])
def test_fp8_flash_vs_fp32_oracle(is_causal, scaling):
    q, k, v = make_qkv(2, 4, 4, 512, 512, 64)
    if scaling == "head":
        q8, sq = quant.quantize_head_wise(q)
        k8, sk = quant.quantize_head_wise(k)
    else:
        q8, sq = quant.quantize_token_wise(q)
        k8, sk = quant.quantize_token_wise(k)
    out = flash_attention(
        q8,
        k8,
        v.astype(jnp.bfloat16),
        scale_q=sq,
        scale_k=sk,
        is_causal=is_causal,
        block_q=128,
        block_kv=128,
    )
    ref = sdpa_reference(q, k, v, is_causal=is_causal)
    assert rmse(out, ref) < RMSE_TOL


def test_fp8_flash_matches_dequant_semantics():
    # The fused op must match dequantize-then-SDPA *tightly* (same math,
    # different blocking), not just the loose fp32 oracle bar.
    q, k, v = make_qkv(1, 2, 2, 256, 384, 128, seed=3)
    q8, sq = quant.quantize_token_wise(q)
    k8, sk = quant.quantize_token_wise(k)
    out = flash_attention(
        q8, k8, v.astype(jnp.bfloat16), scale_q=sq, scale_k=sk,
        block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk)
    assert rmse(out, ref) < 3e-3


def test_fp8_gqa_tokenwise_ragged():
    q, k, v = make_qkv(1, 8, 2, 250, 999, 64, seed=5)
    q8, sq = quant.quantize_token_wise(q)
    k8, sk = quant.quantize_token_wise(k)
    out = flash_attention(
        q8, k8, v.astype(jnp.bfloat16), scale_q=sq, scale_k=sk,
        block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q, k, v)
    assert rmse(out, ref) < RMSE_TOL


@pytest.mark.parametrize("scaling", ["head", "token"])
def test_int8_flash_vs_fp32_oracle(scaling):
    q, k, v = make_qkv(2, 4, 4, 512, 512, 128, seed=7)
    qdt = jnp.int8
    if scaling == "head":
        q8, sq = quant.quantize_head_wise(q, qdt)
        k8, sk = quant.quantize_head_wise(k, qdt)
    else:
        q8, sq = quant.quantize_token_wise(q, qdt)
        k8, sk = quant.quantize_token_wise(k, qdt)
    out = flash_attention(
        q8, k8, v.astype(jnp.bfloat16), scale_q=sq, scale_k=sk,
        is_causal=True, block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_fp8_v_dtype():
    # fp8 V is beyond the reference (its V must stay fp16/bf16): KV-cache
    # storage path. Output must come back bf16.
    q, k, v = make_qkv(1, 2, 2, 256, 256, 64, seed=9)
    q8, sq = quant.quantize_head_wise(q)
    k8, sk = quant.quantize_head_wise(k)
    v8 = jnp.clip(v, -448, 448).astype(jnp.float8_e4m3fn)
    out = flash_attention(
        q8, k8, v8, scale_q=sq, scale_k=sk, block_q=128, block_kv=128
    )
    assert out.dtype == jnp.bfloat16
    ref = sdpa_reference(q, k, v)
    assert rmse(out, ref) < RMSE_TOL


def test_int8_qk_int8_pv_vs_oracle():
    """Full 8-bit path: int8 QK (head-wise scales) + int8 PV (per-channel
    V scales + P scaled by 127) against the dequantized fp32 oracle."""
    from quantumattention_tpu.ops.quant import (
        quantize_channel_wise,
        quantize_head_wise,
    )

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(k1, (2, 4, 512, 128), jnp.float32)
    k = jax.random.normal(k2, (2, 4, 512, 128), jnp.float32)
    v = jax.random.normal(k3, (2, 4, 512, 128), jnp.float32)
    q8, sq = quantize_head_wise(q, jnp.int8)
    k8, sk = quantize_head_wise(k, jnp.int8)
    v8, sv = quantize_channel_wise(v, jnp.int8)

    out = flash_attention(
        q8, k8, v8, scale_q=sq, scale_k=sk, scale_v=sv,
        is_causal=True, block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True)
    assert out.dtype == jnp.bfloat16
    assert rmse(out, ref) < RMSE_TOL


def test_fp8_attn_func_int8_pv_dispatch():
    """The public fp8 path quantizes V channel-wise in-graph when the int8
    container is active."""
    import quantumattention_tpu as qa
    from quantumattention_tpu import config

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(8), 3)
    q = jax.random.normal(k1, (1, 4, 256, 64), jnp.bfloat16)
    k = jax.random.normal(k2, (1, 4, 256, 64), jnp.bfloat16)
    v = jax.random.normal(k3, (1, 4, 256, 64), jnp.bfloat16)
    ref = sdpa_reference(q, k, v, is_causal=True)
    with config.patch({"attention.enable_int8_pv": True}):
        out = qa.fp8_attn_func(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL
    with config.patch({"attention.enable_int8_pv": False}):
        out2 = qa.fp8_attn_func(q, k, v, is_causal=True)
    assert rmse(out2, ref) < RMSE_TOL


def test_per_block_fused_quantization():
    """In-kernel per-block dynamic quantization (BASELINE config 2)."""
    import quantumattention_tpu as qa

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    q = jax.random.normal(k1, (2, 4, 512, 128), jnp.bfloat16)
    k = jax.random.normal(k2, (2, 4, 512, 128), jnp.bfloat16)
    v = jax.random.normal(k3, (2, 4, 512, 128), jnp.bfloat16)
    ref = sdpa_reference(q, k, v, is_causal=True)
    out = qa.fp8_attn_func(
        q, k, v, is_causal=True, scaling_method="per-block"
    )
    err = rmse(out, ref)
    assert err < RMSE_TOL
    # Per-block granularity should be at least as accurate as head-wise at
    # the same int8 container on outlier-heavy inputs (finer scale groups).
    from quantumattention_tpu.ops.quant import quantize_head_wise

    q_out = q.at[0, 0, 10, :].multiply(30.0)  # one outlier token
    ref_o = sdpa_reference(q_out, k, v, is_causal=True)
    e_block = rmse(
        qa.fp8_attn_func(
            q_out, k, v, is_causal=True, scaling_method="per-block"
        ),
        ref_o,
    )
    q8, sq = quantize_head_wise(q_out, jnp.int8)
    k8, sk = quantize_head_wise(k, jnp.int8)
    e_head_int8 = rmse(
        qa.fp8_attn_func(
            q8, k8, v, is_causal=True, scale_q=sq, scale_k=sk,
            scaling_method="head-wise",
        ),
        ref_o,
    )
    assert e_block <= e_head_int8 * 1.2


def test_per_block_gqa_window():
    import quantumattention_tpu as qa

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(10), 3)
    q = jax.random.normal(k1, (1, 8, 384, 64), jnp.bfloat16)
    k = jax.random.normal(k2, (1, 2, 384, 64), jnp.bfloat16)
    v = jax.random.normal(k3, (1, 2, 384, 64), jnp.bfloat16)
    out = qa.fp8_attn_func(
        q, k, v, is_causal=True, scaling_method="per-block",
        window=(128, 0),
    )
    ref = sdpa_reference(q, k, v, is_causal=True, window=(128, None))
    assert rmse(out, ref) < RMSE_TOL


def test_per_block_rejects_scales():
    import quantumattention_tpu as qa

    q = jnp.zeros((1, 2, 128, 64), jnp.bfloat16)
    with pytest.raises(ValueError, match="per-block"):
        qa.fp8_attn_func(
            q, q, q, scaling_method="per-block",
            scale_q=jnp.ones((1, 2)), scale_k=jnp.ones((1, 2)),
        )


def test_fp8_native_dot_forced():
    """The capability-gated fp8-native dot (reference fp8 WGMMA,
    tk/attention.py:233), forced on so CPU interpret mode exercises the
    Hopper code path."""
    from quantumattention_tpu import config
    from quantumattention_tpu.utils import checks

    # Default gate: on only with fp8 tensor cores (compute capability 9.0+).
    assert checks.fp8_dot_enabled() == checks.supports_fp8_tensor_cores()

    q, k, v = make_qkv(2, 4, 4, 384, 384, 64, seed=11)
    q8, sq = quant.quantize_head_wise(q)
    k8, sk = quant.quantize_head_wise(k)
    ref = sdpa_reference(q, k, v, is_causal=True)
    with config.patch({"attention.fp8_dot": True}):
        assert checks.fp8_dot_enabled()
        out = flash_attention(
            q8, k8, v.astype(jnp.bfloat16), scale_q=sq, scale_k=sk,
            is_causal=True, block_q=128, block_kv=128,
        )
    assert rmse(out, ref) < RMSE_TOL
    # And the upcast path agrees tightly (same e4m3 operand values either
    # way; only the multiply unit differs).
    with config.patch({"attention.fp8_dot": False}):
        out_upcast = flash_attention(
            q8, k8, v.astype(jnp.bfloat16), scale_q=sq, scale_k=sk,
            is_causal=True, block_q=128, block_kv=128,
        )
    assert rmse(out, out_upcast) < 1e-3


def test_fp8_native_dot_tokenwise():
    from quantumattention_tpu import config

    q, k, v = make_qkv(1, 4, 2, 256, 999, 64, seed=12)
    q8, sq = quant.quantize_token_wise(q)
    k8, sk = quant.quantize_token_wise(k)
    with config.patch({"attention.fp8_dot": True}):
        out = flash_attention(
            q8, k8, v.astype(jnp.bfloat16), scale_q=sq, scale_k=sk,
            block_q=128, block_kv=128,
        )
    assert rmse(out, sdpa_reference(q, k, v)) < RMSE_TOL


def test_per_block_fp8_container():
    """per-block in-kernel quantization with the fp8 e4m3 container fed
    straight to the dot (the Hopper path)."""
    import quantumattention_tpu as qa
    from quantumattention_tpu import config

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(13), 3)
    q = jax.random.normal(k1, (1, 4, 512, 128), jnp.bfloat16)
    k = jax.random.normal(k2, (1, 4, 512, 128), jnp.bfloat16)
    v = jax.random.normal(k3, (1, 4, 512, 128), jnp.bfloat16)
    ref = sdpa_reference(q, k, v, is_causal=True)
    with config.patch({"attention.fp8_dot": True}):
        out = qa.fp8_attn_func(
            q, k, v, is_causal=True, scaling_method="per-block"
        )
    assert rmse(out, ref) < RMSE_TOL


def test_per_block_k_only_cache():
    """per-block quantization with many small KV tiles per Q tile: each KV
    tile is quantized inside the loop with its own scale (the path long
    contexts take), causal and not."""
    import quantumattention_tpu as qa
    from quantumattention_tpu import config

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(14), 3)
    q = jax.random.normal(k1, (1, 2, 512, 128), jnp.bfloat16)
    k = jax.random.normal(k2, (1, 2, 512, 128), jnp.bfloat16)
    v = jax.random.normal(k3, (1, 2, 512, 128), jnp.bfloat16)
    ref = sdpa_reference(q, k, v, is_causal=True)
    with config.patch({"kernel.block_q": 64, "kernel.block_kv": 32}):
        out = qa.fp8_attn_func(
            q, k, v, is_causal=True, scaling_method="per-block"
        )
        assert rmse(out, ref) < RMSE_TOL
        out_nc = qa.fp8_attn_func(q, k, v, scaling_method="per-block")
    assert rmse(out_nc, sdpa_reference(q, k, v)) < RMSE_TOL


def test_fast_accum_pv():
    """use_fast_accum: bf16-accumulated P@V (reference mm_common.py:79).
    Cross-block accumulation stays fp32, so accuracy degrades only mildly."""
    from quantumattention_tpu import config

    q, k, v = make_qkv(1, 4, 4, 512, 512, 128, seed=15)
    qb, kb, vb = (t.astype(jnp.bfloat16) for t in (q, k, v))
    ref = sdpa_reference(q, k, v, is_causal=True)
    with config.patch({"use_fast_accum": True}):
        out = flash_attention(
            qb, kb, vb, is_causal=True, block_q=128, block_kv=128
        )
    assert rmse(out, ref) < RMSE_TOL


def test_auto_scaling_method_dispatch():
    """scaling_method='auto' (backend-path autotune, the analogue of the
    reference tuning across backends): correct output, cache-hit honored."""
    import quantumattention_tpu as qa
    from quantumattention_tpu import autotune

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    q = jax.random.normal(k1, (1, 4, 256, 64), jnp.bfloat16)
    k = jax.random.normal(k2, (1, 4, 256, 64), jnp.bfloat16)
    v = jax.random.normal(k3, (1, 4, 256, 64), jnp.bfloat16)
    ref = sdpa_reference(q, k, v, is_causal=True)
    # Interpret mode: tuner returns its default without timing.
    out = qa.fp8_attn_func(q, k, v, is_causal=True, scaling_method="auto")
    assert rmse(out, ref) < RMSE_TOL
    # A cached winner must be honored — pin "none" (bf16 path) and check
    # the output now matches the unquantized kernel bit-for-bit.
    pkey = autotune.shape_key("path", 1, 4, 4, 256, 256, 64, True, q.dtype)
    prev = autotune.lookup(pkey)
    try:
        autotune.record(pkey, "none")
        out_none = qa.fp8_attn_func(
            q, k, v, is_causal=True, scaling_method="auto"
        )
        out_bf16 = qa.attn_func(q, k, v, is_causal=True)
        np.testing.assert_array_equal(
            np.asarray(out_none), np.asarray(out_bf16)
        )
    finally:
        if prev is None:
            autotune._load_cache().pop(pkey, None)
            autotune._save_cache()
        else:
            autotune.record(pkey, prev)


def test_auto_rejects_scales_and_8bit():
    import quantumattention_tpu as qa

    q = jnp.zeros((1, 2, 128, 64), jnp.bfloat16)
    with pytest.raises(ValueError, match="auto"):
        qa.fp8_attn_func(
            q, q, q, scaling_method="auto",
            scale_q=jnp.ones((1, 2)), scale_k=jnp.ones((1, 2)),
        )
