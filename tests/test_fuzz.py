"""Seeded shape/config fuzz: random valid configurations vs the oracle.

Coverage insurance for the padding/masking/GQA interaction space that the
hand-picked grids miss (ragged both dims, odd GQA groups, windows crossing
block boundaries, mixed dtypes).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.ops.flash import flash_attention
from quantumattention_tpu.ops.sdpa import sdpa_reference

RMSE_TOL = 1e-2


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_flash_vs_oracle(seed):
    rng = random.Random(seed)
    hkv = rng.choice([1, 2, 3])
    group = rng.choice([1, 2, 4, 5])
    hq = hkv * group
    sq = rng.randrange(16, 640)
    is_causal = rng.random() < 0.5
    skv = sq if is_causal else rng.randrange(16, 640)
    d = rng.choice([64, 128])
    dtype = rng.choice([jnp.bfloat16, jnp.float32])
    window = None
    if rng.random() < 0.4:
        left = rng.randrange(8, max(9, sq))
        window = (left, 0 if is_causal else rng.randrange(0, 64))
    # Tiles the Hopper shared-memory fit model admits (ops/flash.choose_tiles).
    bq = rng.choice([64, 128])
    bkv = rng.choice([32, 64, 128])

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (1, hq, sq, d), jnp.float32).astype(dtype)
    k = jax.random.normal(k2, (1, hkv, skv, d), jnp.float32).astype(dtype)
    v = jax.random.normal(k3, (1, hkv, skv, d), jnp.float32).astype(dtype)

    out = flash_attention(
        q, k, v, is_causal=is_causal, window=window, block_q=bq, block_kv=bkv
    )
    ref_window = (
        (window[0], None) if (window and is_causal) else window
    )
    ref = sdpa_reference(q, k, v, is_causal=is_causal, window=ref_window)
    err = rmse(out, ref)
    assert err < RMSE_TOL, (
        f"seed={seed} hq={hq} hkv={hkv} sq={sq} skv={skv} d={d} "
        f"causal={is_causal} window={window} blocks=({bq},{bkv}): rmse={err}"
    )


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_backward_vs_oracle(seed):
    """Random configs through the custom-VJP backward vs jax.grad of the
    oracle."""
    from quantumattention_tpu.ops.autodiff import attention_with_vjp

    rng = random.Random(1000 + seed)
    hkv = rng.choice([1, 2])
    group = rng.choice([1, 2, 4])
    sq = rng.randrange(64, 384)
    is_causal = rng.random() < 0.5
    d = rng.choice([64, 128])

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (1, hkv * group, sq, d), jnp.float32)
    k = jax.random.normal(k2, (1, hkv, sq, d), jnp.float32)
    v = jax.random.normal(k3, (1, hkv, sq, d), jnp.float32)

    def loss_fused(q, k, v):
        out = attention_with_vjp(
            q, k, v, is_causal=is_causal, block_q=128, block_kv=128
        )
        return jnp.sum(out.astype(jnp.float32) ** 2)

    from quantumattention_tpu.ops.sdpa import sdpa_reference as oracle

    def loss_ref(q, k, v):
        return jnp.sum(oracle(q, k, v, is_causal=is_causal).astype(jnp.float32) ** 2)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(gf, gr, "qkv"):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-9)
        assert err < 3e-2, f"seed={seed} d{name}: {err}"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_decode_quantized_vs_oracle(seed):
    """Random decode configs across containers (int8 / packed int4 / bf16),
    ragged lengths, GQA groups, block sizes — vs a full-precision oracle."""
    from quantumattention_tpu.ops.decode import decode_attention
    from quantumattention_tpu.ops.quant import (
        dynamically_quantize_int4,
        dynamically_quantize_int8,
    )

    rng = random.Random(1000 + seed)
    B = rng.choice([2, 4])
    hkv = rng.choice([1, 2])
    group = rng.choice([1, 2, 4])
    hq = hkv * group
    smax = rng.choice([256, 384, 512])
    d = 128
    container = rng.choice(["int8", "int4", "bf16"])
    block_kv = rng.choice([128, 256])
    block_batch = rng.choice([1, 2])

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2000 + seed), 3)
    q = jax.random.normal(k1, (B, hq, d), jnp.float32)
    kraw = jax.random.normal(k2, (B, hkv, smax, d), jnp.float32)
    vraw = jax.random.normal(k3, (B, hkv, smax, d), jnp.float32)
    lens = jnp.array(
        [rng.randrange(0, smax + 1) for _ in range(B)], jnp.int32
    )

    kwargs = dict(block_kv=block_kv, block_batch=block_batch)
    if container == "int8":
        kc, ks = dynamically_quantize_int8(kraw)
        vc, vs = dynamically_quantize_int8(vraw)
        kwargs.update(k_scale=ks, v_scale=vs)
        tol = RMSE_TOL
    elif container == "int4":
        kc, ks = dynamically_quantize_int4(kraw)
        vc, vs = dynamically_quantize_int4(vraw)
        kwargs.update(k_scale=ks, v_scale=vs)
        tol = 4e-2
    else:
        kc, vc = kraw.astype(jnp.bfloat16), vraw.astype(jnp.bfloat16)
        tol = RMSE_TOL

    out = decode_attention(q.astype(jnp.bfloat16), kc, vc, lens, **kwargs)

    # Full-precision oracle over the valid prefix of each row.
    outs = []
    for b in range(B):
        nvalid = int(lens[b])
        if nvalid == 0:
            outs.append(np.zeros((hq, d), np.float32))
            continue
        o = sdpa_reference(
            q[b][None, :, None, :],
            jnp.repeat(kraw[b][None, :, :nvalid], group, axis=1),
            jnp.repeat(vraw[b][None, :, :nvalid], group, axis=1),
        )
        outs.append(np.asarray(o[0, :, 0, :], np.float32))
    ref = np.stack(outs)
    err = rmse(out, ref)
    assert err < tol, (
        f"seed={seed} B={B} hq={hq} hkv={hkv} smax={smax} "
        f"container={container} lens={list(map(int, lens))} "
        f"blocks=({block_kv},{block_batch}): rmse={err}"
    )
