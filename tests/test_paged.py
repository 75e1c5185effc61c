"""Paged decode attention tests (page gather + decode attention, CPU interpret mode).

Oracle: gather the pages back into a contiguous cache in numpy and run fp32
SDPA on the valid prefix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.ops.paged import paged_decode_attention
from quantumattention_tpu.ops.sdpa import sdpa_reference

RMSE_TOL = 1e-2


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def gather_contiguous(pages, page_indices, b):
    """(Hkv, P, page, D) + page list -> (Hkv, pages_per_seq*page, D)."""
    idx = np.asarray(page_indices[b])
    return np.concatenate([np.asarray(pages[:, p]) for p in idx], axis=1)


def make_paged(B, Hkv, pages_per_seq, page_size, D, seed=0):
    """Random float pages + a shuffled page table."""
    total_pages = B * pages_per_seq + 3
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    k_pages = jax.random.normal(k1, (Hkv, total_pages, page_size, D), jnp.float32)
    v_pages = jax.random.normal(k2, (Hkv, total_pages, page_size, D), jnp.float32)
    rng = np.random.RandomState(seed)
    table = rng.permutation(total_pages - 1)[: B * pages_per_seq].reshape(
        B, pages_per_seq
    )
    return k_pages, v_pages, jnp.asarray(table, jnp.int32)


@pytest.mark.parametrize("group", [1, 4])
def test_paged_bf16(group):
    B, Hkv, pages_per_seq, page_size, D = 3, 2, 8, 64, 64
    Hq = Hkv * group
    k_pages, v_pages, table = make_paged(B, Hkv, pages_per_seq, page_size, D)
    q = jax.random.normal(jax.random.PRNGKey(9), (B, Hq, D), jnp.float32)
    lengths = jnp.array([512, 200, 1], jnp.int32)

    out = paged_decode_attention(
        q.astype(jnp.bfloat16),
        k_pages.astype(jnp.bfloat16),
        v_pages.astype(jnp.bfloat16),
        lengths,
        table,
    )

    for b in range(B):
        n = int(lengths[b])
        kc = gather_contiguous(k_pages, table, b)[:, :n]
        vc = gather_contiguous(v_pages, table, b)[:, :n]
        ref = sdpa_reference(
            q[b][None, :, None, :], jnp.asarray(kc)[None], jnp.asarray(vc)[None]
        )[0, :, 0, :]
        assert rmse(out[b], ref) < RMSE_TOL, f"seq {b}"


def test_paged_int8_quantized_pages():
    B, Hkv, pages_per_seq, page_size, D = 2, 2, 8, 64, 128
    Hq = Hkv * 4
    k_pages, v_pages, table = make_paged(B, Hkv, pages_per_seq, page_size, D, seed=3)
    q = jax.random.normal(jax.random.PRNGKey(4), (B, Hq, D), jnp.float32)
    lengths = jnp.array([512, 130], jnp.int32)

    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    k8, ks = dynamically_quantize_int8(k_pages, reduction_dim=-1)
    v8, vs = dynamically_quantize_int8(v_pages, reduction_dim=-1)

    out = paged_decode_attention(
        q.astype(jnp.bfloat16),
        k8,
        v8,
        lengths,
        table,
        k_scale_pages=ks,
        v_scale_pages=vs,
    )

    for b in range(B):
        n = int(lengths[b])
        kc = gather_contiguous(k_pages, table, b)[:, :n]
        vc = gather_contiguous(v_pages, table, b)[:, :n]
        ref = sdpa_reference(
            q[b][None, :, None, :], jnp.asarray(kc)[None], jnp.asarray(vc)[None]
        )[0, :, 0, :]
        assert rmse(out[b], ref) < RMSE_TOL, f"seq {b}"


def test_paged_validation():
    q = jnp.zeros((1, 4, 64), jnp.bfloat16)
    kp = jnp.zeros((2, 8, 64, 64), jnp.int8)
    vp = jnp.zeros((2, 8, 64, 64), jnp.int8)
    table = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(ValueError, match="scale"):
        paged_decode_attention(q, kp, vp, jnp.array([5], jnp.int32), table)
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(
            q,
            kp.astype(jnp.bfloat16),
            vp.astype(jnp.bfloat16),
            jnp.array([5], jnp.int32),
            table,
            window=(4, 2),
        )


def test_paged_rejects_malformed_scale_pages():
    """ADVICE r2: a scale extent that is neither page_rows (int8) nor
    2*page_rows (token-packed int4) is a malformed scale array and must
    raise, not silently reinterpret the pages under a wrong layout."""
    q = jnp.zeros((1, 4, 64), jnp.bfloat16)
    kp = jnp.zeros((2, 8, 64, 64), jnp.int8)
    vp = jnp.zeros((2, 8, 64, 64), jnp.int8)
    table = jnp.zeros((1, 4), jnp.int32)
    lengths = jnp.array([5], jnp.int32)
    bad = jnp.ones((2, 8, 48), jnp.float32)  # 48 is neither 64 nor 128
    good = jnp.ones((2, 8, 64), jnp.float32)
    with pytest.raises(ValueError, match="token rows"):
        paged_decode_attention(
            q, kp, vp, lengths, table, k_scale_pages=bad, v_scale_pages=bad
        )
    # k/v scale extents must agree (one int8-shaped, one int4-shaped).
    with pytest.raises(ValueError, match="disagree"):
        paged_decode_attention(
            q, kp, vp, lengths, table,
            k_scale_pages=good, v_scale_pages=jnp.ones((2, 8, 128)),
        )


def test_paged_sliding_window_matches_decode():
    """window=(left, 0) on the paged kernel must equal the contiguous
    decode kernel with the same window (gathered layout)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantumattention_tpu.ops.decode import decode_attention
    from quantumattention_tpu.ops.paged import paged_decode_attention

    Hkv, P, ps, D, B, Hq = 2, 8, 64, 64, 2, 4
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    kp = jax.random.normal(k1, (Hkv, P, ps, D), jnp.bfloat16)
    vp = jax.random.normal(k2, (Hkv, P, ps, D), jnp.bfloat16)
    q = jax.random.normal(k3, (B, Hq, D), jnp.bfloat16)
    tables = jnp.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], jnp.int32)
    lengths = jnp.asarray([200, 30], jnp.int32)

    o_p = paged_decode_attention(q, kp, vp, lengths, tables, window=(7, 0))

    def gather(pages, t):
        g = jnp.take(pages, t, axis=1)
        return g.reshape((g.shape[0], -1) + g.shape[3:])

    ks = jax.vmap(lambda t: gather(kp, t))(tables)
    vs = jax.vmap(lambda t: gather(vp, t))(tables)
    o_d = decode_attention(q, ks, vs, lengths, window=(7, 0))
    err = float(
        jnp.sqrt(jnp.mean(
            (o_p.astype(jnp.float32) - o_d.astype(jnp.float32)) ** 2
        ))
    )
    assert err < 1e-6, err


def test_paged_int4_token_packed_pages():
    """int4 pages pack two TOKENS per byte along the page's token axis
    (serving/paged_cache.init_layer_pages layout); the gather unpacks
    them along the token axis.  Oracle: fp32 SDPA over the dequantized
    gathered prefix."""
    from quantumattention_tpu.ops.quant import (
        pack_int4, quantize_int4_values, unpack_int4,
    )

    B, Hkv, pages_per_seq, page_size, D = 2, 2, 8, 64, 128
    Hq = Hkv * 4
    k_pages, v_pages, table = make_paged(
        B, Hkv, pages_per_seq, page_size, D, seed=11
    )
    q = jax.random.normal(jax.random.PRNGKey(12), (B, Hq, D), jnp.float32)
    lengths = jnp.array([512, 130], jnp.int32)

    kq, ks = quantize_int4_values(k_pages, reduction_dim=-1)
    vq, vs = quantize_int4_values(v_pages, reduction_dim=-1)
    kp4 = pack_int4(kq, axis=2)  # (Hkv, P, ps/2, D)
    vp4 = pack_int4(vq, axis=2)
    assert kp4.shape == (Hkv, B * pages_per_seq + 3, page_size // 2, D)

    out = paged_decode_attention(
        q.astype(jnp.bfloat16), kp4, vp4, lengths, table,
        k_scale_pages=ks, v_scale_pages=vs,
    )

    # Dequantized oracle: the packed container must round-trip exactly.
    kd = unpack_int4(kp4, jnp.float32, axis=2) * np.asarray(ks)[..., None]
    vd = unpack_int4(vp4, jnp.float32, axis=2) * np.asarray(vs)[..., None]
    np.testing.assert_allclose(
        np.asarray(kd), np.asarray(kq, np.float32) * np.asarray(ks)[..., None]
    )
    for b in range(B):
        n = int(lengths[b])
        kc = gather_contiguous(kd, table, b)[:, :n]
        vc = gather_contiguous(vd, table, b)[:, :n]
        ref = sdpa_reference(
            q[b][None, :, None, :], jnp.asarray(kc)[None], jnp.asarray(vc)[None]
        )[0, :, 0, :]
        assert rmse(out[b], ref) < RMSE_TOL, f"seq {b}"


def test_paged_int4_write_tokens_roundtrip():
    """write_tokens on int4 pages: nibble-packed pages must read back as
    the exact int4 quantization of the written tokens, including partial
    pages and a second write that lands mid-page (the RMW path)."""
    from quantumattention_tpu.serving import paged_cache as pgc
    from quantumattention_tpu.ops.quant import (
        quantize_int4_values, unpack_int4,
    )

    Hkv, P, ps, D = 2, 6, 8, 16
    pages = pgc.init_layer_pages(Hkv, P, ps, D, jnp.int8, int4=True)
    assert pages.k.shape == (Hkv, P, ps // 2, D)

    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    t1 = 13  # pages [4, 2]: full page 4 + 5 rows of page 2
    k_new = jax.random.normal(k1, (Hkv, t1, D), jnp.float32)
    v_new = jax.random.normal(k2, (Hkv, t1, D), jnp.float32)
    pages = pgc.write_tokens(
        pages, jnp.asarray([4, 2], jnp.int32), 0, k_new, v_new
    )
    # Second write resumes mid-page (offset 5 of page 2): tokens 13..19.
    k_more = jax.random.normal(jax.random.PRNGKey(5), (Hkv, 7, D), jnp.float32)
    v_more = jax.random.normal(jax.random.PRNGKey(6), (Hkv, 7, D), jnp.float32)
    pages = pgc.write_tokens(
        pages, jnp.asarray([2, 1], jnp.int32), 5, k_more, v_more
    )

    k_all = jnp.concatenate([k_new, k_more], axis=1)  # (Hkv, 20, D)
    kq, ks = quantize_int4_values(k_all, reduction_dim=-1)
    got = np.asarray(unpack_int4(pages.k, jnp.int8, axis=2))
    gs = np.asarray(pages.k_scale)
    want = np.asarray(kq)
    ws = np.asarray(ks)
    # Page map: tokens 0..7 -> page 4, 8..15 -> page 2, 16..19 -> page 1.
    # Values must round-trip EXACTLY; scales only to float tolerance (the
    # write path computes them inside jit, a 1-ULP difference vs eager).
    np.testing.assert_array_equal(got[:, 4], want[:, 0:8])
    np.testing.assert_array_equal(got[:, 2], want[:, 8:16])
    np.testing.assert_array_equal(got[:, 1, :4], want[:, 16:20])
    np.testing.assert_allclose(gs[:, 4], ws[:, 0:8], rtol=1e-5)
    np.testing.assert_allclose(gs[:, 2], ws[:, 8:16], rtol=1e-5)
    np.testing.assert_allclose(gs[:, 1, :4], ws[:, 16:20], rtol=1e-5)


def test_paged_multi_query_matches_decode():
    """4-D q (speculative verification): the paged path's
    multi-query mode must match the contiguous decode kernel's 4-D mode
    (same (group, token) row packing, same intra-chunk causal mask) on a
    gathered layout."""
    from quantumattention_tpu.ops.decode import decode_attention

    Hkv, P, ps, D, B, group, T = 2, 8, 64, 64, 2, 2, 3
    Hq = Hkv * group
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    kp = jax.random.normal(k1, (Hkv, P, ps, D), jnp.bfloat16)
    vp = jax.random.normal(k2, (Hkv, P, ps, D), jnp.bfloat16)
    q = jax.random.normal(k3, (B, Hq, T, D), jnp.bfloat16)
    tables = jnp.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], jnp.int32)
    # lengths INCLUDE the T appended candidates (decode_attention contract)
    lengths = jnp.asarray([203, 33], jnp.int32)

    o_p = paged_decode_attention(
        q, kp, vp, lengths, tables
    )
    assert o_p.shape == (B, Hq, T, D)

    def gather(pages, t):
        g = jnp.take(pages, t, axis=1)
        return g.reshape((g.shape[0], -1) + g.shape[3:])

    ks = jax.vmap(lambda t: gather(kp, t))(tables)
    vs = jax.vmap(lambda t: gather(vp, t))(tables)
    o_d = decode_attention(q, ks, vs, lengths)
    assert rmse(o_p, o_d) < 1e-6

    # Cross-check one (b, t) row against the fp32 oracle: token t sees
    # exactly lengths - (T-1-t) keys.
    b, t = 0, 1
    n = int(lengths[b]) - (T - 1 - t)
    kc = gather_contiguous(np.asarray(kp, np.float32), tables, b)[:, :n]
    vc = gather_contiguous(np.asarray(vp, np.float32), tables, b)[:, :n]
    qrow = q[b, :, t, :].astype(jnp.float32)
    ref = sdpa_reference(
        qrow[None, :, None, :], jnp.asarray(kc)[None], jnp.asarray(vc)[None]
    )[0, :, 0, :]
    assert rmse(o_p[b, :, t, :], ref) < RMSE_TOL


def test_paged_multi_query_window():
    """Multi-query x sliding window on the paged kernel vs the contiguous
    decode kernel."""
    from quantumattention_tpu.ops.decode import decode_attention

    Hkv, P, ps, D, B, group, T = 2, 8, 64, 64, 2, 4, 2
    Hq = Hkv * group
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(6), 3)
    kp = jax.random.normal(k1, (Hkv, P, ps, D), jnp.bfloat16)
    vp = jax.random.normal(k2, (Hkv, P, ps, D), jnp.bfloat16)
    q = jax.random.normal(k3, (B, Hq, T, D), jnp.bfloat16)
    tables = jnp.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], jnp.int32)
    lengths = jnp.asarray([202, 34], jnp.int32)

    o_p = paged_decode_attention(
        q, kp, vp, lengths, tables,
        window=(15, 0),
    )

    def gather(pages, t):
        g = jnp.take(pages, t, axis=1)
        return g.reshape((g.shape[0], -1) + g.shape[3:])

    ks = jax.vmap(lambda t: gather(kp, t))(tables)
    vs = jax.vmap(lambda t: gather(vp, t))(tables)
    o_d = decode_attention(q, ks, vs, lengths, window=(15, 0))
    assert rmse(o_p, o_d) < 1e-6


def test_paged_folded_scale_pages_ps256():
    """page_size=256 pages carry FOLDED (Hkv, P, 2, 128) scale pages
    (serving/paged_cache.scale_shape); the gather must consume the folded
    layout."""
    B, Hkv, pages_per_seq, page_size, D = 2, 2, 4, 256, 128
    Hq = Hkv * 4
    k_pages, v_pages, table = make_paged(
        B, Hkv, pages_per_seq, page_size, D, seed=5
    )
    q = jax.random.normal(jax.random.PRNGKey(6), (B, Hq, D), jnp.float32)
    lengths = jnp.array([900, 257], jnp.int32)

    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    k8, ks = dynamically_quantize_int8(k_pages, reduction_dim=-1)
    v8, vs = dynamically_quantize_int8(v_pages, reduction_dim=-1)
    P = k8.shape[1]
    ks_f = ks.reshape(Hkv, P, 2, 128)
    vs_f = vs.reshape(Hkv, P, 2, 128)

    out = paged_decode_attention(
        q.astype(jnp.bfloat16),
        k8,
        v8,
        lengths,
        table,
        k_scale_pages=ks_f,
        v_scale_pages=vs_f,
    )
    for b in range(B):
        n = int(lengths[b])
        kc = gather_contiguous(k_pages, table, b)[:, :n]
        vc = gather_contiguous(v_pages, table, b)[:, :n]
        ref = sdpa_reference(
            q[b][None, :, None, :], jnp.asarray(kc)[None],
            jnp.asarray(vc)[None],
        )[0, :, 0, :]
        assert rmse(out[b], ref) < RMSE_TOL, b


def test_paged_folded_scale_write_roundtrip():
    """write_tokens + the backend decode scatter land scales correctly in
    the folded layout (offsets split into (row//128, row%128))."""
    from quantumattention_tpu.serving import paged_cache as pgc

    Hkv, P, ps, D = 2, 6, 256, 128
    pages = pgc.init_layer_pages(Hkv, P, ps, D, jnp.int8)
    assert pages.k_scale.shape == (Hkv, P, 2, 128)

    k_new = jax.random.normal(jax.random.PRNGKey(0), (Hkv, ps, D), jnp.float32)
    v_new = jax.random.normal(jax.random.PRNGKey(1), (Hkv, ps, D), jnp.float32)
    pages = pgc.write_tokens(
        pages, jnp.asarray([3], jnp.int32), 0, k_new, v_new
    )
    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    kq, ks = dynamically_quantize_int8(k_new, reduction_dim=-1)
    got = np.asarray(pages.k_scale[:, 3]).reshape(Hkv, ps)
    np.testing.assert_allclose(got, np.asarray(ks), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(pages.k[:, 3]), np.asarray(kq))


def test_engine_paged_ps256_matches_ps128():
    """End-to-end: a paged engine at page_size=256 (folded scales)
    produces the same schedule/first tokens as page_size=128."""
    from quantumattention_tpu.models import llama
    from quantumattention_tpu.serving.engine import Engine

    cfg = llama.tiny(attention_impl="sdpa", dtype=jnp.float32)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    outs = {}
    for ps in (128, 256):
        eng = Engine(
            params, cfg, num_slots=2, max_len=512, cache_dtype=jnp.int8,
            cache_backend="paged", page_size=ps, prefill_bucket=256,
        )
        reqs = [
            eng.submit([3, 1, 4, 1, 5], max_new_tokens=6),
            eng.submit([2, 7, 1, 8], max_new_tokens=6),
        ]
        eng.run_to_completion()
        assert all(r.done and len(r.output) == 6 for r in reqs)
        outs[ps] = [r.output[0] for r in reqs]
    # First tokens are prefill-determined (flash path, identical between
    # page sizes); later tokens go through the CPU-nondeterministic paged
    # decode (CLAUDE.md) and are not compared.
    assert outs[128] == outs[256]


def _side_oracle(q, kc, vc, side_kf, side_vf, n_side, b):
    """fp32 SDPA over cache prefix + the slot's valid side tokens."""
    k_all = jnp.concatenate([kc, jnp.asarray(side_kf[b, :, :n_side])], axis=1)
    v_all = jnp.concatenate([vc, jnp.asarray(side_vf[b, :, :n_side])], axis=1)
    return sdpa_reference(
        q[b][None, :, None, :], k_all[None], v_all[None]
    )[0, :, 0, :]


@pytest.mark.parametrize("use_jit", [True, False])
def test_paged_side_buffer_int8(use_jit):
    """Burst side buffer: decode attends cache-prefix pages + a
    (B, Hkv, Tpad, D) side buffer of this burst's appended tokens, so the
    page pool can stay scan-invariant across a decode burst
    (serving/backends.PagedBackend._burst_impl_side).  Oracle: fp32 SDPA
    over the dequantized prefix + each slot's valid side prefix."""
    from quantumattention_tpu.ops.paged import MASK_VALUE
    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    B, Hkv, pages_per_seq, page_size, D = 3, 2, 4, 128, 128
    Hq = Hkv * 4
    tpad = 8
    k_pages, v_pages, table = make_paged(B, Hkv, pages_per_seq, page_size, D, seed=5)
    q = jax.random.normal(jax.random.PRNGKey(6), (B, Hq, D), jnp.float32)
    lengths = jnp.array([300, 130, 0], jnp.int32)
    n_side = np.array([5, 3, 0])

    k8, ks = dynamically_quantize_int8(k_pages, reduction_dim=-1)
    v8, vs = dynamically_quantize_int8(v_pages, reduction_dim=-1)

    kf, vf = jax.random.normal(
        jax.random.PRNGKey(7), (2, B, Hkv, tpad, D), jnp.float32
    )
    sk8, sks = dynamically_quantize_int8(kf, reduction_dim=-1)
    sv8, svs = dynamically_quantize_int8(vf, reduction_dim=-1)
    mask = jnp.where(
        jnp.arange(tpad)[None, :] < jnp.asarray(n_side)[:, None],
        0.0, MASK_VALUE,
    ).astype(jnp.float32)

    def run(q, k8, v8, lengths, table, ks, vs, side):
        return paged_decode_attention(
            q, k8, v8, lengths, table, k_scale_pages=ks, v_scale_pages=vs,
            side=side,
        )

    out = (jax.jit(run) if use_jit else run)(
        q.astype(jnp.bfloat16), k8, v8, lengths, table, ks, vs,
        {"k": sk8, "v": sv8, "ks": sks, "vs": svs, "mask": mask},
    )

    side_kf = np.asarray(sk8, np.float32) * np.asarray(sks)[..., None]
    side_vf = np.asarray(sv8, np.float32) * np.asarray(svs)[..., None]
    for b in range(B):
        n = int(lengths[b])
        if n == 0:
            # Zero-length slots return exact zeros by contract even with
            # valid side columns (the engine never bursts unprefilled
            # slots).
            np.testing.assert_array_equal(np.asarray(out[b]), 0.0)
            continue
        kc = jnp.asarray(gather_contiguous(k_pages, table, b)[:, :n])
        vc = jnp.asarray(gather_contiguous(v_pages, table, b)[:, :n])
        ref = _side_oracle(q, kc, vc, side_kf, side_vf, int(n_side[b]), b)
        assert rmse(out[b], ref) < RMSE_TOL, f"seq {b}"


def test_paged_side_buffer_bf16():
    """Unquantized pages + side buffer (no scales)."""
    from quantumattention_tpu.ops.paged import MASK_VALUE

    B, Hkv, pages_per_seq, page_size, D = 2, 2, 4, 128, 128
    Hq = Hkv * 2
    tpad = 8
    k_pages, v_pages, table = make_paged(B, Hkv, pages_per_seq, page_size, D, seed=8)
    q = jax.random.normal(jax.random.PRNGKey(9), (B, Hq, D), jnp.float32)
    lengths = jnp.array([200, 128], jnp.int32)
    n_side = np.array([8, 1])
    kf, vf = jax.random.normal(
        jax.random.PRNGKey(10), (2, B, Hkv, tpad, D), jnp.float32
    )
    mask = jnp.where(
        jnp.arange(tpad)[None, :] < jnp.asarray(n_side)[:, None],
        0.0, MASK_VALUE,
    ).astype(jnp.float32)
    out = paged_decode_attention(
        q.astype(jnp.bfloat16),
        k_pages.astype(jnp.bfloat16), v_pages.astype(jnp.bfloat16),
        lengths, table,
        side={
            "k": kf.astype(jnp.bfloat16), "v": vf.astype(jnp.bfloat16),
            "mask": mask,
        },
    )
    for b in range(B):
        n = int(lengths[b])
        kc = jnp.asarray(gather_contiguous(k_pages, table, b)[:, :n])
        vc = jnp.asarray(gather_contiguous(v_pages, table, b)[:, :n])
        ref = _side_oracle(q, kc, vc, kf, vf, int(n_side[b]), b)
        assert rmse(out[b], ref) < RMSE_TOL, f"seq {b}"


def test_paged_side_buffer_validation():
    from quantumattention_tpu.ops.paged import MASK_VALUE

    B, Hkv, pages_per_seq, page_size, D = 2, 2, 4, 128, 128
    k_pages, v_pages, table = make_paged(B, Hkv, pages_per_seq, page_size, D)
    q = jnp.zeros((B, Hkv, D), jnp.bfloat16)
    lengths = jnp.array([10, 10], jnp.int32)
    side = {
        "k": jnp.zeros((B, Hkv, 8, D), jnp.bfloat16),
        "v": jnp.zeros((B, Hkv, 8, D), jnp.bfloat16),
        "mask": jnp.full((B, 8), MASK_VALUE, jnp.float32),
    }
    kb, vb = k_pages.astype(jnp.bfloat16), v_pages.astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="sliding window"):
        paged_decode_attention(
            q, kb, vb, lengths, table, window=(16, 0), side=side,
        )
    with pytest.raises(ValueError, match="single-token"):
        paged_decode_attention(
            q[:, :, None, :].repeat(2, axis=2), kb, vb, lengths, table,
            side=side,
        )
    bad = dict(side, k=side["k"][:, :, :7])
    with pytest.raises(ValueError, match="side buffer shape"):
        paged_decode_attention(q, kb, vb, lengths, table, side=bad)
