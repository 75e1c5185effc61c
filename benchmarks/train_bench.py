"""Training-step throughput through the fused forward + per-head plain
backward.

Usage: python benchmarks/train_bench.py [--layers 2] [--seq 2048] [--batch 4]
(on a GPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from quantumattention_tpu.models import llama
from quantumattention_tpu.utils.profiling import bench


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--attention-impl", default="bf16",
                   choices=["bf16", "fp8", "sdpa"])
    args = p.parse_args()

    cfg = llama.llama3_8b(
        num_layers=args.layers, vocab_size=32000,
        attention_impl=args.attention_impl,
    )
    params = llama.init_params(jax.random.PRNGKey(1), cfg)
    tokens = jax.random.randint(
        jax.random.PRNGKey(2), (args.batch, args.seq), 0, cfg.vocab_size
    )
    t = bench(lambda p, t: llama.train_step(p, t, cfg), (params, tokens),
              iters=4)
    toks = args.batch * (args.seq - 1) / t
    print(
        f"train step ({args.layers}L 8B-shapes S={args.seq} B={args.batch} "
        f"{args.attention_impl}): {t * 1e3:.1f} ms  {toks:,.0f} tok/s"
    )


if __name__ == "__main__":
    main()
