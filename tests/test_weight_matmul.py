"""Weight-only quantized matmul (models/quantized.matmul): w8a16 and w4a16
against an fp32 reference, over decode-, ragged- and prefill-shaped
activations, 3-D expert stacks and the tied output head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.models import quantized


def _rel_rmse(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.sqrt(np.mean((g - w) ** 2)) / (np.std(w) + 1e-9))


def _fp32_reference(x, w):
    """x @ dequantized(w) entirely in fp32."""
    if quantized.is_quantized4(w):
        wf = quantized.dequantize_int4(w, jnp.float32)
    else:
        wf = w["q"].astype(jnp.float32) * w["s"]
    return jnp.einsum("mk,kn->mn", x.astype(jnp.float32), wf,
                      precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize(
    "m,k,n,dtype",
    [
        (16, 512, 512, jnp.bfloat16),   # decode shape class
        (33, 256, 384, jnp.float32),    # ragged M
        (128, 1024, 256, jnp.bfloat16),  # prefill-like rows
        (8, 256, 128, jnp.float32),     # smallest int4 packing block
    ],
)
def test_weight_matmul_matches_fp32(bits, m, k, n, dtype):
    k1, k2 = jax.random.split(jax.random.PRNGKey(bits))
    x = jax.random.normal(k1, (m, k), jnp.float32).astype(dtype)
    wf = jax.random.normal(k2, (k, n), jnp.float32) / k**0.5
    w = (quantized.quantize_matrix(wf) if bits == 8
         else quantized.quantize_matrix_int4(wf))
    got = quantized.matmul("mk,kn->mn", x, w)
    assert got.shape == (m, n) and got.dtype == dtype
    # bf16 activations round the product once; fp32 ones match tightly.
    tol = 1e-2 if dtype == jnp.bfloat16 else 1e-5
    assert _rel_rmse(got, _fp32_reference(x, w)) < tol


def test_weight_matmul_expert_stack():
    """3-D (E, in, out) expert stacks keep per-expert output scales."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.normal(k1, (2, 5, 256), jnp.float32)
    wf = jax.random.normal(k2, (2, 256, 128), jnp.float32) / 16
    w = quantized.quantize_matrix(wf)
    got = quantized.matmul("ets,eso->eto", x, w)
    want = jnp.einsum("ets,eso->eto", x, w["q"].astype(jnp.float32) * w["s"])
    assert _rel_rmse(got, want) < 1e-5


def test_weight_matmul_unquantized_passthrough():
    x = jax.random.normal(jax.random.PRNGKey(4), (3, 7, 64), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(5), (64, 32), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(quantized.matmul("bse,eo->bso", x, w)),
        np.asarray(jnp.einsum("bse,eo->bso", x, w)),
    )


def test_tied_head_matmul_quantized():
    """Row-quantized embedding as the output head: x @ embed.T."""
    emb = jax.random.normal(jax.random.PRNGKey(6), (300, 64), jnp.float32)
    qe = quantized.quantize_embed(emb)
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 3, 64), jnp.float32)
    got = quantized.tied_head_matmul(x, qe)
    want = jnp.einsum("bse,ve->bsv", x,
                      qe["q"].astype(jnp.float32) * qe["s"])
    assert got.shape == (2, 3, 300)
    assert _rel_rmse(got, want) < 1e-5
