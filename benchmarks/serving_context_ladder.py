"""Serving throughput vs context length (8B, int8 W+KV, one process).

The round-4 grid fixed max_len=512; this ladder holds the KV-byte budget
roughly constant (slots x max_len) and shows how decode tokens/s and
step time move as context doubles — the attention share of the step
grows with live context while the weight stream stays fixed.

Usage: python benchmarks/serving_context_ladder.py  (on a GPU; one process)
"""

import gc
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

cfg = llama.llama3_8b()
params = quantized.fuse_projections(
    quantized.init_quantized_params(jax.random.PRNGKey(0), cfg)
)
jax.block_until_ready(params)
print("weights ready", flush=True)


def run(slots, max_len, prompt, new=129, burst=64):
    eng = Engine(params, cfg, num_slots=slots, max_len=max_len,
                 cache_dtype=jnp.int8, prefill_bucket=prompt)
    prompts = [
        [(7 * i + j) % 1000 + 1 for j in range(prompt)] for i in range(slots)
    ]
    reqs = [eng.submit(p, max_new_tokens=burst + 1) for p in prompts]
    eng.run_to_completion(decode_burst=burst)  # warm
    assert all(r.done for r in reqs)
    best = float("inf")
    for _ in range(2):
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        while eng.waiting or eng.prefilling:
            eng.step()
        t0 = time.perf_counter()
        eng.run_to_completion(decode_burst=burst)
        best = min(best, time.perf_counter() - t0)
        assert all(r.done and len(r.output) == new for r in reqs)
    steps = new - 1
    print(json.dumps({
        "slots": slots, "max_len": max_len, "prompt": prompt,
        "decode_ms_per_step": round(best / steps * 1e3, 2),
        "decode_tok_s": round(slots * steps / best, 1),
    }), flush=True)
    del eng
    gc.collect()


# ~constant KV budget (slots x max_len = 32k tokens of KV)
run(64, 512, 128)
run(32, 1024, 512)
run(16, 2048, 1024)
run(8, 4096, 2048)
# 32 slots x 2048 max_len (4.3 GB cache beside 8.5 GB weights) exceeds
# the chip at decode transients — same capacity wall as 128 x 512
# (model_grid.py); the iso-budget ladder above is the valid frontier.
print("DONE", flush=True)
