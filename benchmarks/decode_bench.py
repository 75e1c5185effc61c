"""Decode-attention throughput: int8/int4 vs bf16 KV cache (BASELINE decode
config).

Usage: python benchmarks/decode_bench.py [--batch 64] [--seq 4096]
(on a GPU; timing is the host clock around block_until_ready).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from quantumattention_tpu.ops.decode import decode_attention
from quantumattention_tpu.ops.quant import (
    dynamically_quantize_int4,
    dynamically_quantize_int8,
)
from quantumattention_tpu.utils.profiling import bench


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--q-heads", type=int, default=32)
    p.add_argument("--kv-heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--seq", type=int, default=4096)
    args = p.parse_args()
    B, Hq, Hkv, D, S = (
        args.batch, args.q_heads, args.kv_heads, args.head_dim, args.seq
    )

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.bfloat16)
    kc = jax.random.normal(k2, (B, Hkv, S, D), jnp.float32)
    vc = jax.random.normal(k3, (B, Hkv, S, D), jnp.float32)
    k8, ks = dynamically_quantize_int8(kc, reduction_dim=-1)
    v8, vs = dynamically_quantize_int8(vc, reduction_dim=-1)
    lengths = jnp.full((B,), S, jnp.int32)
    hbm = B * Hkv * S * D * 2 + B * Hkv * S * 4 * 2  # int8 k+v + scales

    t8 = bench(
        lambda q, k, v, ks, vs, l: decode_attention(
            q, k, v, l, k_scale=ks, v_scale=vs
        ),
        (q, k8, v8, ks, vs, lengths),
        iters=256,
    )
    print(
        f"int8 KV: {t8 * 1e3:.2f} ms/step  {B / t8:,.0f} tok/s  "
        f"{hbm / t8 / 1e9:.0f} GB/s"
    )

    kb, vb = kc.astype(jnp.bfloat16), vc.astype(jnp.bfloat16)
    tb = bench(
        lambda q, k, v, l: decode_attention(q, k, v, l),
        (q, kb, vb, lengths),
        iters=256,
    )
    print(
        f"bf16 KV: {tb * 1e3:.2f} ms/step  {B / tb:,.0f} tok/s  "
        f"(int8 speedup {tb / t8:.2f}x)"
    )

    k4, ks4 = dynamically_quantize_int4(kc, reduction_dim=-1)
    v4, vs4 = dynamically_quantize_int4(vc, reduction_dim=-1)
    t4 = bench(
        lambda q, k, v, ks, vs, l: decode_attention(
            q, k, v, l, k_scale=ks, v_scale=vs
        ),
        (q, k4, v4, ks4, vs4, lengths),
        iters=256,
    )
    print(
        f"int4 KV (packed): {t4 * 1e3:.2f} ms/step  {B / t4:,.0f} tok/s  "
        f"(capacity feature: half the int8 residency; see README)"
    )


if __name__ == "__main__":
    main()
