"""Automatic prefix caching at Llama-3-8B shapes: prefill cost with cold
vs hot prefix cache, on the paged backend.

Round 1 prefills 16 x 512-token prompts that share a 384-token prefix
(cold cache: full prefill + page registration).  Round 2 resubmits the
same prompts (hot: each adopts the cached prefix pages and prefills only
its tail chunk).  Decode is held constant (burst path is slot-backend
only, so per-step decode here — the comparison is prefill wall time).

Usage: python benchmarks/prefix_cache_bench.py   (on a GPU; one process)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from quantumattention_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from quantumattention_tpu.models import llama, quantized
from quantumattention_tpu.serving.engine import Engine

SLOTS, PROMPT, PAGE, CHUNK = 16, 512, 128, 256


def main():
    cfg = llama.llama3_8b()
    params = quantized.fuse_projections(
        quantized.init_quantized_params(jax.random.PRNGKey(0), cfg)
    )
    jax.block_until_ready(params)
    print("weights ready", flush=True)

    eng = Engine(params, cfg, num_slots=SLOTS, max_len=1024,
                 cache_dtype=jnp.int8, cache_backend="paged",
                 page_size=PAGE, prefill_chunk=CHUNK, prefix_cache=True,
                 num_pages=SLOTS * 8 + 64)
    shared = [(3 * j) % 997 + 1 for j in range(384)]
    prompts = [
        shared + [(11 * i + j) % 997 + 1 for j in range(PROMPT - 384)]
        for i in range(SLOTS)
    ]

    def one_round(tag):
        hits0 = eng.stats["prefix_hits"]
        toks0 = eng.stats["prefill_tokens"]
        reqs = [eng.submit(list(p), max_new_tokens=2) for p in prompts]
        t0 = time.perf_counter()
        while eng.waiting or eng.prefilling:
            eng.step()
        jax.block_until_ready(eng.pages[0].k)
        dt = time.perf_counter() - t0
        eng.run_to_completion()
        assert all(r.done and len(r.output) == 2 for r in reqs)
        print(json.dumps({
            "round": tag,
            "prefill_s": round(dt, 2),
            "prefill_tok_s": round(SLOTS * PROMPT / dt, 1),
            "prefix_hits": eng.stats["prefix_hits"] - hits0,
            "tokens_prefilled": eng.stats["prefill_tokens"] - toks0,
            "tokens_reused_total": eng.stats["prefix_tokens_reused"],
        }), flush=True)
        return [r.output[0] for r in reqs]

    # Round 1: cold cache (full prefill; compiles the off=0/256 chunk
    # programs and registers every prompt's whole pages).  Round 2: hot
    # cache but pays the off=384 resume-chunk compile.  Round 3: hot
    # cache, all programs warm — the honest hot number.
    t1 = one_round("cold")
    t2 = one_round("hot_compiling")
    t3 = one_round("hot")
    print(json.dumps({
        "first_tokens_equal_across_rounds": t2 == t3,
    }), flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
