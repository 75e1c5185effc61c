"""End-to-end serving throughput: continuous batching + burst decode.

Measures engine-level tokens/s (all layers, sampling, scheduling included)
on a Llama-3-8B-attention-geometry model scaled to fit one chip alongside
its KV cache, comparing per-step decode against jitted burst decode.

Usage: python benchmarks/serving_bench.py [--slots 32] [--burst 16]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from quantumattention_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    p = argparse.ArgumentParser()
    p.add_argument("--slots", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=256)
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--burst", type=int, default=16)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--tiny", action="store_true", help="CPU smoke config")
    args = p.parse_args()

    if args.tiny:
        # CPU smoke of the tiny config.
        jax.config.update("jax_platforms", "cpu")

    from quantumattention_tpu.models import llama
    from quantumattention_tpu.serving.engine import Engine

    if args.tiny:
        cfg = llama.tiny(attention_impl="bf16")
        max_len = 256
        args.slots = 4
        args.prompt_len, args.max_new = 32, 16
    else:
        # Llama-3-8B attention geometry (32 q heads / 8 kv heads / D=128),
        # few layers.
        cfg = llama.LlamaConfig(
            vocab_size=32768, hidden_size=4096, intermediate_size=8192,
            num_layers=args.layers, num_q_heads=32, num_kv_heads=8,
            head_dim=128, attention_impl="bf16",
        )
        max_len = args.prompt_len + args.max_new

    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    prompts = [
        rng.randint(1, cfg.vocab_size, size=args.prompt_len).tolist()
        for _ in range(args.slots)
    ]

    def run(burst):
        eng = Engine(
            params, cfg, num_slots=args.slots, max_len=max_len,
            cache_dtype=jnp.int8,
        )
        for pr in prompts:
            eng.submit(pr, max_new_tokens=args.max_new)
        t0 = time.perf_counter()
        eng.run_to_completion(decode_burst=burst)
        dt = time.perf_counter() - t0
        toks = args.slots * args.max_new
        return toks / dt, dt

    # Warm compile with a first run, then measure.
    run(None)
    tps_step, dt1 = run(None)
    print(f"per-step decode: {tps_step:,.0f} tok/s ({dt1:.2f} s)")
    run(args.burst)
    tps_burst, dt2 = run(args.burst)
    print(
        f"burst decode (n={args.burst}): {tps_burst:,.0f} tok/s "
        f"({dt2:.2f} s, {tps_burst / tps_step:.2f}x)"
    )


if __name__ == "__main__":
    main()
