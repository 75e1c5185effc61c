"""Long-context causal prefill throughput (BASELINE config 3).

Usage: python benchmarks/longcontext_bench.py [--seq 131072]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import quantumattention_tpu as qa
from quantumattention_tpu import config
from quantumattention_tpu.utils.profiling import attention_tflops, bench


def main():
    from quantumattention_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=int, default=131072)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--window", type=int, default=None)
    args = p.parse_args()
    S, H, D = args.seq, args.heads, args.head_dim

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (1, H, S, D), jnp.bfloat16)
    k = jax.random.normal(k2, (1, H, S, D), jnp.bfloat16)
    v = jax.random.normal(k3, (1, H, S, D), jnp.bfloat16)

    window = (args.window, 0) if args.window else None
    wtag = f" window={args.window}" if args.window else ""
    # Pin the measured-best blocks for the whole run: an autotune sweep at
    # 131K context would spend many minutes per candidate compile for
    # marginal gain.
    config.set("kernel.block_q", 1024)
    config.set("kernel.block_kv", 2048)
    fn = jax.jit(
        lambda q, k, v: qa.attn_func(q, k, v, is_causal=True, window=window)
    )
    t = bench(fn, (q, k, v), iters=3)
    print(
        f"S={S} causal{wtag} bf16: {t * 1e3:.1f} ms  "
        f"{attention_tflops(t, 1, H, S, S, D, causal=True):.1f} TFLOP/s"
    )
    # Per-block in-kernel quantized path: must stay >= bf16 at long context
    fn_pb = jax.jit(
        lambda q, k, v: qa.fp8_attn_func(
            q, k, v, is_causal=True, scaling_method="per-block",
            window=window,
        )
    )
    t_pb = bench(fn_pb, (q, k, v), iters=3)
    print(
        f"S={S} causal{wtag} per-block: {t_pb * 1e3:.1f} ms  "
        f"{attention_tflops(t_pb, 1, H, S, S, D, causal=True):.1f} TFLOP/s "
        f"({t / t_pb:.2f}x bf16)"
    )


if __name__ == "__main__":
    main()
