"""Differential tests: Pallas flash kernel vs fp32 SDPA oracle.

Mirrors the reference's end-to-end differential strategy
(reference: tests/test_interface.py:31-59): seeded random inputs, RMSE vs
the unfused oracle < 1e-2, parameter grids covering ragged tails, GQA,
causal, and head dims {64, 128, 256}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.ops.flash import flash_attention
from quantumattention_tpu.ops.sdpa import sdpa_reference

RMSE_TOL = 1e-2  # reference tests/test_interface.py:57-59


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def make_qkv(batch, hq, hkv, sq, skv, d, dtype=jnp.bfloat16, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (batch, hq, sq, d), jnp.float32)
    k = jax.random.normal(k2, (batch, hkv, skv, d), jnp.float32)
    v = jax.random.normal(k3, (batch, hkv, skv, d), jnp.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


@pytest.mark.parametrize("sq,skv", [(512, 512), (512, 384), (250, 999)])
@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_vs_oracle(sq, skv, is_causal, d):
    if is_causal and sq != skv:
        pytest.skip("causal + rectangular skipped (reference parity)")
    q, k, v = make_qkv(2, 4, 4, sq, skv, d)
    out = flash_attention(q, k, v, is_causal=is_causal, block_q=128, block_kv=128)
    ref = sdpa_reference(q, k, v, is_causal=is_causal)
    assert out.shape == q.shape
    assert rmse(out, ref) < RMSE_TOL


def test_flash_gqa():
    q, k, v = make_qkv(1, 8, 2, 256, 512, 64)
    out = flash_attention(q, k, v, block_q=128, block_kv=128)
    ref = sdpa_reference(q, k, v)
    assert rmse(out, ref) < RMSE_TOL


def test_flash_causal_gqa_d256():
    q, k, v = make_qkv(1, 4, 2, 384, 384, 256)
    out = flash_attention(q, k, v, is_causal=True, block_q=128, block_kv=128)
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_flash_sliding_window():
    q, k, v = make_qkv(1, 2, 2, 512, 512, 64)
    out = flash_attention(
        q, k, v, is_causal=True, window=(128, 0), block_q=128, block_kv=128
    )
    ref = sdpa_reference(q, k, v, is_causal=True, window=(128, None))
    assert rmse(out, ref) < RMSE_TOL


def test_flash_residuals_consistent():
    q, k, v = make_qkv(1, 2, 2, 256, 256, 64)
    out, (m, l) = flash_attention(
        q, k, v, block_q=128, block_kv=128, return_residuals=True
    )
    assert m.shape == l.shape == (1, 2, 256)
    # m is the exp2-domain row max of the scaled logits, l the row sum of
    # exp2(logits - m).
    qf, kf = np.asarray(q, np.float32), np.asarray(k, np.float32)
    logits = np.einsum("bhqd,bhkd->bhqk", qf, kf) / np.sqrt(64) * np.log2(np.e)
    m_ref = logits.max(-1)
    l_ref = np.exp2(logits - m_ref[..., None]).sum(-1)
    np.testing.assert_allclose(np.asarray(m), m_ref, rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(np.asarray(l), l_ref, rtol=5e-2)
    ref = sdpa_reference(q, k, v)
    assert rmse(out, ref) < RMSE_TOL


def test_flash_offsets_shift_causal_mask():
    # With kv_offset = -Skv the whole KV block is "in the past": causal
    # masking must become a no-op.
    q, k, v = make_qkv(1, 2, 2, 256, 256, 64)
    out = flash_attention(
        q,
        k,
        v,
        is_causal=True,
        q_offset=jnp.int32(256),
        kv_offset=jnp.int32(0),
        block_q=128,
        block_kv=128,
    )
    ref = sdpa_reference(q, k, v)  # fully visible
    assert rmse(out, ref) < RMSE_TOL


def test_flash_segment_ids_packed_sequences():
    """Packed-document masking: tokens attend only within their segment."""
    q, k, v = make_qkv(2, 4, 4, 384, 384, 64)
    seg = jnp.asarray(
        np.concatenate([np.zeros(100), np.ones(150), np.full(134, 2)])[None]
        .repeat(2, 0),
        jnp.int32,
    )
    out = flash_attention(
        q, k, v, is_causal=True,
        q_segment_ids=seg, kv_segment_ids=seg,
        block_q=128, block_kv=128,
    )
    ref = sdpa_reference(
        q, k, v, is_causal=True, q_segment_ids=seg, kv_segment_ids=seg
    )
    assert rmse(out, ref) < RMSE_TOL


def test_flash_segment_ids_ragged():
    q, k, v = make_qkv(1, 2, 2, 250, 250, 64)
    seg = jnp.asarray(
        np.concatenate([np.zeros(130), np.ones(120)])[None], jnp.int32
    )
    out = flash_attention(
        q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
        block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    assert rmse(out, ref) < RMSE_TOL


def test_flash_segment_ids_validation():
    q, k, v = make_qkv(1, 2, 2, 128, 128, 64)
    with pytest.raises(ValueError, match="both"):
        flash_attention(q, k, v, q_segment_ids=jnp.zeros((1, 128), jnp.int32))


# ---------------------------------------------------------------------------
# Block-sparse masks (splash-style; beyond the reference's causal/ragged)
# ---------------------------------------------------------------------------


def _expand_block_mask(bm, sq, skv, g=128):
    e = np.repeat(np.repeat(np.asarray(bm, bool), g, axis=0), g, axis=1)
    return e[:sq, :skv]


@pytest.mark.parametrize("is_causal", [False, True])
def test_block_sparse_mask_vs_oracle(is_causal):
    import quantumattention_tpu as qa

    b, h, s, d = 1, 2, 1024, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(41), 3)
    q = jax.random.normal(k1, (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(k2, (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(k3, (b, h, s, d), jnp.bfloat16)
    rng = np.random.RandomState(0)
    bm = rng.rand(s // 128, s // 128) < 0.5
    bm[np.arange(s // 128), np.arange(s // 128)] = True  # keep diagonal
    out = qa.attn_func(
        q, k, v, is_causal=is_causal, block_mask=jnp.asarray(bm)
    )
    elem = _expand_block_mask(bm, s, s)
    if is_causal:
        elem = elem & np.tril(np.ones((s, s), bool))
    ref = sdpa_reference(q, k, v, attn_mask=jnp.asarray(elem[None, None]))
    assert rmse(out, ref) < RMSE_TOL


def test_block_sparse_ragged_and_gqa():
    import quantumattention_tpu as qa

    b, hq, hkv, sq, skv, d = 1, 4, 2, 250, 999, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(43), 3)
    q = jax.random.normal(k1, (b, hq, sq, d), jnp.bfloat16)
    k = jax.random.normal(k2, (b, hkv, skv, d), jnp.bfloat16)
    v = jax.random.normal(k3, (b, hkv, skv, d), jnp.bfloat16)
    nq, nk = -(-sq // 128), -(-skv // 128)
    rng = np.random.RandomState(1)
    bm = rng.rand(nq, nk) < 0.6
    bm[0, 0] = True
    out = qa.attn_func(q, k, v, block_mask=jnp.asarray(bm))
    elem = _expand_block_mask(bm, sq, skv)
    ref = sdpa_reference(q, k, v, attn_mask=jnp.asarray(elem[None, None]))
    assert rmse(out, ref) < RMSE_TOL


def test_block_sparse_fully_masked_rows_zero():
    import quantumattention_tpu as qa

    b, h, s, d = 1, 2, 512, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(44), 3)
    q = jax.random.normal(k1, (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(k2, (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(k3, (b, h, s, d), jnp.bfloat16)
    bm = np.ones((4, 4), bool)
    bm[2, :] = False  # rows 256:384 attend to nothing
    out = qa.attn_func(q, k, v, block_mask=jnp.asarray(bm))
    out_np = np.asarray(out, np.float32)
    assert np.all(out_np[:, :, 256:384, :] == 0.0)
    assert np.any(out_np[:, :, :256, :] != 0.0)


def test_block_sparse_traced_mask_matches_concrete():
    """A mask passed as a traced jit argument takes the full-grid fallback;
    a concrete (closed-over) mask takes the compact grid.  Both must agree
    with each other and the oracle."""
    import quantumattention_tpu as qa

    b, h, s, d = 1, 2, 1024, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    q = jax.random.normal(k1, (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(k2, (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(k3, (b, h, s, d), jnp.bfloat16)
    rng = np.random.RandomState(3)
    bm = rng.rand(s // 128, s // 128) < 0.4
    bm[np.arange(s // 128), np.arange(s // 128)] = True

    compact = qa.attn_func(q, k, v, is_causal=True, block_mask=jnp.asarray(bm))
    traced = jax.jit(
        lambda q, k, v, m: qa.attn_func(q, k, v, is_causal=True, block_mask=m)
    )(q, k, v, jnp.asarray(bm))
    elem = _expand_block_mask(bm, s, s) & np.tril(np.ones((s, s), bool))
    ref = sdpa_reference(q, k, v, attn_mask=jnp.asarray(elem[None, None]))
    assert rmse(compact, ref) < RMSE_TOL
    assert rmse(traced, ref) < RMSE_TOL
    assert rmse(compact, traced) < 1e-6  # same math, different grids


def test_block_sparse_shape_validation():
    import quantumattention_tpu as qa

    q = jnp.zeros((1, 2, 512, 64), jnp.bfloat16)
    with pytest.raises(ValueError, match="block_mask"):
        qa.attn_func(q, q, q, block_mask=jnp.ones((3, 4), jnp.int32))


@pytest.mark.parametrize("path", ["bf16", "per-block"])
def test_softmax_bf16_mode(path):
    """kernel.softmax_bf16: reduced-precision probability tile must stay
    inside the accuracy bar on both the float and quantized paths."""
    import quantumattention_tpu as qa
    from quantumattention_tpu import config

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(51), 3)
    q = jax.random.normal(k1, (1, 4, 512, 64), jnp.bfloat16)
    k = jax.random.normal(k2, (1, 4, 512, 64), jnp.bfloat16)
    v = jax.random.normal(k3, (1, 4, 512, 64), jnp.bfloat16)
    ref = sdpa_reference(q, k, v, is_causal=True)
    with config.patch({"kernel.softmax_bf16": True}):
        if path == "bf16":
            out = qa.attn_func(q, k, v, is_causal=True)
        else:
            out = qa.fp8_attn_func(
                q, k, v, is_causal=True, scaling_method="per-block"
            )
    assert rmse(out, ref) < RMSE_TOL
