"""Block-sparse prefill throughput (splash-style granule bitmap).

Covers the two regimes that matter:

  * **Structured masks** (the production case): packed-document /
    block-diagonal and causal+local+global patterns, where whole kernel
    tiles are empty — each Q tile loops only over its list of active KV
    tiles, so wall-clock scales with density.
  * **Random granule masks** (the honest worst case): at any useful kernel
    block size a fine-grained random mask almost never zeroes a whole
    block, so only the fine-mask overhead shows.

Usage: python benchmarks/sparse_bench.py [--seq 8192] [--doc 1024]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def bench(fn, q, k, v, iters=10):
    from quantumattention_tpu.utils.profiling import bench as time_jit

    return time_jit(fn, (q, k, v), iters)


def document_mask(n, doc_granules):
    """Packed-document block-diagonal mask over n granules."""
    bm = np.zeros((n, n), bool)
    for s in range(0, n, doc_granules):
        e = min(s + doc_granules, n)
        bm[s:e, s:e] = True
    return bm


def local_global_mask(n, local_granules, n_global):
    """Causal sliding window + a few global-attention granule columns."""
    r = np.arange(n)
    bm = (r[:, None] >= r[None, :]) & (r[:, None] - r[None, :] < local_granules)
    bm[:, :n_global] = True
    return bm


def main():
    from quantumattention_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--doc", type=int, default=1024, help="document length")
    p.add_argument("--density", type=float, default=0.25)
    p.add_argument(
        "--block-kv", type=int, default=None,
        help="kernel KV block for the sparse runs (skip resolution)",
    )
    args = p.parse_args()

    import quantumattention_tpu as qa
    from quantumattention_tpu import config

    b, h, s, d = args.batch, args.heads, args.seq, args.head_dim
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(k2, (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(k3, (b, h, s, d), jnp.bfloat16)

    n = s // 128
    flops_dense = 4 * b * h * s * s * d
    t_dense = bench(lambda q, k, v: qa.attn_func(q, k, v), q, k, v)
    print(
        f"dense:  {t_dense * 1e3:.2f} ms  "
        f"{flops_dense / t_dense / 1e12:.1f} TFLOP/s"
    )

    cases = [
        ("documents", document_mask(n, args.doc // 128)),
        ("local+global", local_global_mask(n, 8, 2)),
    ]
    rng = np.random.RandomState(0)
    rnd = rng.rand(n, n) < args.density
    rnd[np.arange(n), np.arange(n)] = True
    cases.append(("random (worst case)", rnd))

    patch = {}
    if args.block_kv:
        patch = {"kernel.block_kv": args.block_kv}
    for name, bm in cases:
        density = float(bm.mean())
        bm_j = jnp.asarray(bm)
        with config.patch(patch) if patch else _null():
            t = bench(
                lambda q, k, v: qa.attn_func(q, k, v, block_mask=bm_j),
                q, k, v,
            )
        print(
            f"sparse[{name}] density {density:.2f}: {t * 1e3:.2f} ms  "
            f"speedup {t_dense / t:.2f}x  "
            f"active-block {flops_dense * density / t / 1e12:.1f} TFLOP/s"
        )


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


if __name__ == "__main__":
    main()
