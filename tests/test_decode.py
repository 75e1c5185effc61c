"""Decode-path tests: ragged GQA decode kernel + quantized KV cache.

Differential oracle: fp32 SDPA over the dequantized valid cache prefix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.ops.decode import decode_attention
from quantumattention_tpu.ops.sdpa import sdpa_reference
from quantumattention_tpu.serving import kv_cache as kvc

RMSE_TOL = 1e-2


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def oracle_decode(q, k, v, lengths):
    """Loop over batch; full-precision attention on the valid prefix."""
    outs = []
    for b in range(q.shape[0]):
        n = int(lengths[b])
        if n == 0:
            outs.append(np.zeros_like(np.asarray(q[b], np.float32)))
            continue
        o = sdpa_reference(
            q[b][None, :, None, :],  # (1, Hq, 1, D)
            k[b][None, :, :n, :],
            v[b][None, :, :n, :],
        )
        outs.append(np.asarray(o[0, :, 0, :], np.float32))
    return np.stack(outs)


@pytest.mark.parametrize("group", [1, 4])
def test_decode_bf16_ragged(group):
    B, Hkv, Smax, D = 4, 2, 640, 64
    Hq = Hkv * group
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.float32)
    k = jax.random.normal(k2, (B, Hkv, Smax, D), jnp.float32)
    v = jax.random.normal(k3, (B, Hkv, Smax, D), jnp.float32)
    lengths = jnp.array([640, 1, 130, 0], jnp.int32)

    out = decode_attention(
        q.astype(jnp.bfloat16),
        k.astype(jnp.bfloat16),
        v.astype(jnp.bfloat16),
        lengths,
        block_kv=128,
    )
    ref = oracle_decode(q, k, v, lengths)
    assert out.shape == (B, Hq, D)
    assert rmse(out, ref) < RMSE_TOL


def test_decode_int8_quantized_cache():
    B, Hkv, group, Smax, D = 2, 2, 4, 512, 128
    Hq = Hkv * group
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = jax.random.split(key, 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.float32)
    k = jax.random.normal(k2, (B, Hkv, Smax, D), jnp.float32)
    v = jax.random.normal(k3, (B, Hkv, Smax, D), jnp.float32)
    lengths = jnp.array([512, 300], jnp.int32)

    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    k8, ks = dynamically_quantize_int8(k, reduction_dim=-1)
    v8, vs = dynamically_quantize_int8(v, reduction_dim=-1)

    out = decode_attention(
        q.astype(jnp.bfloat16),
        k8,
        v8,
        lengths,
        k_scale=ks,
        v_scale=vs,
        block_kv=256,
    )
    ref = oracle_decode(q, k, v, lengths)
    assert rmse(out, ref) < RMSE_TOL


def test_decode_rejects_8bit_without_scales():
    q = jnp.zeros((1, 4, 64), jnp.bfloat16)
    kc = jnp.zeros((1, 2, 128, 64), jnp.int8)
    vc = jnp.zeros((1, 2, 128, 64), jnp.int8)
    with pytest.raises(ValueError, match="scale"):
        decode_attention(q, kc, vc, jnp.array([5], jnp.int32))


def test_kv_cache_append_and_decode_roundtrip():
    """Append float tokens into the int8 cache, decode, compare to oracle."""
    slots, Hkv, Smax, D, group = 3, 2, 256, 64, 2
    Hq = Hkv * group
    cache = kvc.init_cache(slots, Hkv, Smax, D, dtype=jnp.int8)

    key = jax.random.PRNGKey(2)
    k1, k2, k3 = jax.random.split(key, 3)
    T = 100
    k_new = jax.random.normal(k1, (2, Hkv, T, D), jnp.float32)
    v_new = jax.random.normal(k2, (2, Hkv, T, D), jnp.float32)

    cache = kvc.append(
        cache,
        jnp.array([0, 2], jnp.int32),
        k_new,
        v_new,
        jnp.array([0, 0], jnp.int32),
        jnp.array([T, 60], jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(cache.lengths), [100, 0, 60])

    q = jax.random.normal(k3, (slots, Hq, D), jnp.float32)
    out = decode_attention(
        q.astype(jnp.bfloat16),
        cache.k,
        cache.v,
        cache.lengths,
        k_scale=cache.k_scale,
        v_scale=cache.v_scale,
        block_kv=128,
    )

    # Oracle over the float tokens actually appended.
    k_full = np.zeros((slots, Hkv, Smax, D), np.float32)
    v_full = np.zeros((slots, Hkv, Smax, D), np.float32)
    k_full[0, :, :T] = np.asarray(k_new[0])
    v_full[0, :, :T] = np.asarray(v_new[0])
    k_full[2, :, :60] = np.asarray(k_new[1, :, :60])
    v_full[2, :, :60] = np.asarray(v_new[1, :, :60])
    ref = oracle_decode(q, k_full, v_full, np.array([100, 0, 60]))
    assert rmse(out, ref) < RMSE_TOL

    cache = kvc.free_slots(cache, jnp.array([0], jnp.int32))
    np.testing.assert_array_equal(np.asarray(cache.lengths), [0, 0, 60])


def test_decode_int4_packed_cache():
    """Packed-int4 cache (minor dim D/2) unpacks in-kernel and tracks the
    float oracle within int4 tolerance; beyond the reference (8-bit max) —
    decode is DMA-bound at the HBM roof, so halving bytes is the lever."""
    from quantumattention_tpu.ops.quant import dynamically_quantize_int4

    B, Hkv, Smax, D = 4, 2, 512, 128
    Hq = 8
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.float32)
    k = jax.random.normal(k2, (B, Hkv, Smax, D), jnp.float32)
    v = jax.random.normal(k3, (B, Hkv, Smax, D), jnp.float32)
    lengths = jnp.array([512, 300, 128, 0], jnp.int32)

    kc4, ks = dynamically_quantize_int4(k)
    vc4, vs = dynamically_quantize_int4(v)
    assert kc4.shape == (B, Hkv, Smax, D // 2)

    out = decode_attention(
        q.astype(jnp.bfloat16), kc4, vc4, lengths,
        k_scale=ks, v_scale=vs, block_kv=256, block_batch=2,
    )
    ref = oracle_decode(q, k, v, lengths)
    assert out.shape == (B, Hq, D)
    # int4 tolerance: ~4x the int8 budget (one fewer bit each for K and V).
    assert rmse(out, ref) < 4e-2
    # Zero-length row stays exactly zero.
    assert np.all(np.asarray(out[3]) == 0.0)


def test_decode_int4_rejects_non_int8_container():
    B, Hkv, Smax, D = 2, 2, 256, 128
    q = jnp.zeros((B, 4, D), jnp.bfloat16)
    bad = jnp.zeros((B, Hkv, Smax, D // 2), jnp.bfloat16)
    s = jnp.ones((B, Hkv, Smax), jnp.float32)
    with pytest.raises(ValueError, match="int8 container"):
        decode_attention(q, bad, bad, jnp.full((B,), 8, jnp.int32),
                         k_scale=s, v_scale=s)


def test_kv_cache_int4_append_and_decode():
    """init_cache(int4=True) stores packed halves; append quantizes+packs;
    decode_attention auto-detects the packed layout from the minor dim."""
    B, Hkv, Smax, D, Hq = 2, 2, 256, 128, 4
    cache = kvc.init_cache(B, Hkv, Smax, D, int4=True)
    assert cache.k.shape == (B, Hkv, Smax, D // 2)

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    T = 64
    k_new = jax.random.normal(k1, (B, Hkv, T, D), jnp.float32)
    v_new = jax.random.normal(k2, (B, Hkv, T, D), jnp.float32)
    cache = kvc.append(
        cache,
        jnp.arange(B, dtype=jnp.int32),
        k_new, v_new,
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), T, jnp.int32),
    )
    assert int(cache.lengths[0]) == T

    q = jax.random.normal(k3, (B, Hq, D), jnp.float32)
    out = decode_attention(
        q.astype(jnp.bfloat16), cache.k, cache.v, cache.lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale, block_kv=128,
    )
    ref = oracle_decode(q, k_new, v_new, cache.lengths)
    assert rmse(out, ref) < 4e-2


def test_decode_multi_token_verification():
    """4-D q = (B, Hq, T, D): the kernel's multi-query mode (speculative
    verification).  lengths include the T appended candidates; token t
    attends to everything before the candidates plus candidates 0..t."""
    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    B, Hq, Hkv, D, S, T = 3, 8, 2, 128, 512, 4
    G = Hq // Hkv
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (B, Hq, T, D), jnp.float32)
    kraw = jax.random.normal(k2, (B, Hkv, S, D), jnp.float32)
    vraw = jax.random.normal(k3, (B, Hkv, S, D), jnp.float32)
    lengths = jnp.array([100 + T, 37 + T, T], jnp.int32)
    kc, ks = dynamically_quantize_int8(kraw)
    vc, vs = dynamically_quantize_int8(vraw)

    out = decode_attention(
        q.astype(jnp.bfloat16), kc, vc, lengths,
        k_scale=ks, v_scale=vs, block_kv=128, block_batch=1,
    )
    assert out.shape == (B, Hq, T, D)

    ref = np.zeros((B, Hq, T, D), np.float32)
    for b in range(B):
        for t in range(T):
            n = int(lengths[b]) - (T - 1 - t)
            o = sdpa_reference(
                q[b][None, :, t : t + 1, :],
                jnp.repeat(kraw[b][None, :, :n], G, 1),
                jnp.repeat(vraw[b][None, :, :n], G, 1),
            )
            ref[b, :, t] = np.asarray(o[0, :, 0], np.float32)
    assert rmse(out, ref) < RMSE_TOL


def test_decode_sliding_window():
    """window=(left, 0): decode tokens only attend to the trailing
    left+1 keys — must match the oracle restricted to that window."""
    B, Hkv, Smax, D = 3, 2, 512, 64
    Hq, left = 4, 31
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.float32)
    k = jax.random.normal(k2, (B, Hkv, Smax, D), jnp.float32)
    v = jax.random.normal(k3, (B, Hkv, Smax, D), jnp.float32)
    lengths = jnp.array([512, 200, 16], jnp.int32)

    out = decode_attention(
        q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
        v.astype(jnp.bfloat16), lengths,
        block_kv=128, window=(left, 0),
    )
    G = Hq // Hkv
    ref = np.zeros((B, Hq, D), np.float32)
    for b in range(B):
        n = int(lengths[b])
        lo = max(0, n - 1 - left)
        o = sdpa_reference(
            q[b][None, :, None, :],
            jnp.repeat(k[b][None, :, lo:n], G, 1),
            jnp.repeat(v[b][None, :, lo:n], G, 1),
        )
        ref[b] = np.asarray(o[0, :, 0], np.float32)
    assert rmse(out, ref) < RMSE_TOL


def test_decode_auto_window_block_is_power_of_two():
    """The decode kernel's KV tile is a power of two and its splits tile
    every power-of-two cache extent exactly — a non-dividing tiling would
    make decode_attention jnp.pad the ENTIRE cache (plus scales) every
    step."""
    from quantumattention_tpu.ops.decode import decode_tiling

    for batch, kv_heads in [(1, 1), (2, 8), (16, 8), (64, 8)]:
        for s_max in (128, 4096, 8192, 16384, 131072):
            bkv, splits, split_len = decode_tiling(batch, kv_heads, s_max)
            assert bkv & (bkv - 1) == 0  # power of two
            assert split_len % bkv == 0
            assert split_len * splits == s_max, (batch, kv_heads, s_max)
    with pytest.raises(ValueError, match="power of two"):
        decode_tiling(1, 1, 4096, block_kv=96)
    # The shared-memory fit model sets the pipeline depth and rejects
    # tiles that cannot run on the card.
    from quantumattention_tpu.ops.decode import decode_stages

    assert decode_stages(16, 128, 128, 1) == 3
    assert decode_stages(16, 256, 128, 2) == 1
    with pytest.raises(ValueError, match="shared memory"):
        decode_stages(16, 2048, 128, 1)


def test_decode_auto_window_block_correct_pow2_window():
    """End-to-end: a window of exactly 1024 (the shape the old default
    mis-blocked) with the AUTO block_kv still matches the windowed
    oracle."""
    B, Hkv, Smax, D = 2, 1, 4096, 128
    Hq, left = 8, 1024
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.float32)
    k = jax.random.normal(k2, (B, Hkv, Smax, D), jnp.float32)
    v = jax.random.normal(k3, (B, Hkv, Smax, D), jnp.float32)
    lengths = jnp.array([4096, 1500], jnp.int32)

    out = decode_attention(
        q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
        v.astype(jnp.bfloat16), lengths, window=(left, 0),
    )
    G = Hq // Hkv
    ref = np.zeros((B, Hq, D), np.float32)
    for b in range(B):
        n = int(lengths[b])
        lo = max(0, n - 1 - left)
        o = sdpa_reference(
            q[b][None, :, None, :],
            jnp.repeat(k[b][None, :, lo:n], G, 1),
            jnp.repeat(v[b][None, :, lo:n], G, 1),
        )
        ref[b] = np.asarray(o[0, :, 0], np.float32)
    assert rmse(out, ref) < RMSE_TOL


def test_decode_window_rejects_right_extent():
    q = jnp.zeros((2, 4, 64), jnp.bfloat16)
    kv = jnp.zeros((2, 2, 128, 64), jnp.bfloat16)
    with pytest.raises(ValueError, match="right"):
        decode_attention(q, kv, kv, jnp.full((2,), 8, jnp.int32),
                         window=(16, 4))


def test_decode_sliding_window_quantized_and_ragged():
    """Window mode with an int8 cache and ragged lengths: exercises the
    j-innermost grid, the clamped KV/scale index maps, and the
    below-window block skip against the windowed oracle."""
    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    B, Hkv, Smax, D = 4, 2, 768, 128
    Hq, left = 8, 63
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.float32)
    kraw = jax.random.normal(k2, (B, Hkv, Smax, D), jnp.float32)
    vraw = jax.random.normal(k3, (B, Hkv, Smax, D), jnp.float32)
    lengths = jnp.array([768, 700, 130, 0], jnp.int32)
    kc, ks = dynamically_quantize_int8(kraw)
    vc, vs = dynamically_quantize_int8(vraw)

    out = decode_attention(
        q.astype(jnp.bfloat16), kc, vc, lengths,
        k_scale=ks, v_scale=vs, block_kv=128, block_batch=2,
        window=(left, 0),
    )
    G = Hq // Hkv
    ref = np.zeros((B, Hq, D), np.float32)
    for b in range(B):
        n = int(lengths[b])
        if n == 0:
            continue
        lo = max(0, n - 1 - left)
        o = sdpa_reference(
            q[b][None, :, None, :],
            jnp.repeat(kraw[b][None, :, lo:n], G, 1),
            jnp.repeat(vraw[b][None, :, lo:n], G, 1),
        )
        ref[b] = np.asarray(o[0, :, 0], np.float32)
    assert rmse(out, ref) < RMSE_TOL
    assert np.all(np.asarray(out[3], np.float32) == 0.0)


def test_decode_multi_token_verification_int4():
    """Multi-query mode over the PACKED-INT4 cache (speculative
    verification with kv_int4=True): in-kernel unpack + per-row
    intra-chunk causality must track the float oracle within the int4
    budget."""
    from quantumattention_tpu.ops.quant import dynamically_quantize_int4

    B, Hq, Hkv, D, S, T = 2, 8, 2, 128, 384, 4
    G = Hq // Hkv
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    q = jax.random.normal(k1, (B, Hq, T, D), jnp.float32)
    kraw = jax.random.normal(k2, (B, Hkv, S, D), jnp.float32)
    vraw = jax.random.normal(k3, (B, Hkv, S, D), jnp.float32)
    lengths = jnp.array([100 + T, 37 + T], jnp.int32)
    kc4, ks = dynamically_quantize_int4(kraw)
    vc4, vs = dynamically_quantize_int4(vraw)
    assert kc4.shape[-1] == D // 2  # packed container

    out = decode_attention(
        q.astype(jnp.bfloat16), kc4, vc4, lengths,
        k_scale=ks, v_scale=vs, block_kv=128, block_batch=1,
    )
    assert out.shape == (B, Hq, T, D)

    ref = np.zeros((B, Hq, T, D), np.float32)
    for b in range(B):
        for t in range(T):
            n = int(lengths[b]) - (T - 1 - t)
            o = sdpa_reference(
                q[b][None, :, t : t + 1, :],
                jnp.repeat(kraw[b][None, :, :n], G, 1),
                jnp.repeat(vraw[b][None, :, :n], G, 1),
            )
            ref[b, :, t] = np.asarray(o[0, :, 0], np.float32)
    # int4 tolerance: ~4x the int8 budget (one fewer bit each for K and V).
    assert rmse(out, ref) < 4e-2
