"""Engine prefill-phase breakdown at Llama-3-8B shapes.

prefill_probe.py showed the jitted forward itself runs at ~9.3k tok/s
(440 ms for a 16x256 batch), but the engine measures 1.7-2.9k tok/s —
this probe times each phase of the whole-batch prefill path to find the
missing second: forward dispatch, the one-jit 32-layer cache append, the
first-token argmax fetch, and the full engine step.

Usage: python benchmarks/engine_prefill_probe.py   (on a GPU; one process)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from quantumattention_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from quantumattention_tpu.models import llama, quantized
from quantumattention_tpu.serving.engine import Engine

cfg = llama.llama3_8b()
SLOTS, PROMPT = 16, 256


def t(label, fn, reps=3):
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out) if out is not None else None
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({"phase": label, "ms": round(best * 1e3, 1)}),
          flush=True)
    return out


def main():
    params = quantized.fuse_projections(
        quantized.init_quantized_params(jax.random.PRNGKey(0), cfg)
    )
    jax.block_until_ready(params)
    print("weights ready", flush=True)

    eng = Engine(params, cfg, num_slots=SLOTS, max_len=1024,
                 cache_dtype=jnp.int8, prefill_bucket=PROMPT)
    prompts = [
        [(7 * i + j) % 1000 + 1 for j in range(PROMPT)] for i in range(SLOTS)
    ]
    # warm everything once
    reqs = [eng.submit(p, max_new_tokens=2) for p in prompts]
    eng.run_to_completion()
    assert all(r.done for r in reqs)

    # phase timings on the warm engine
    tokens = np.zeros((SLOTS, PROMPT), np.int32)
    for i, p in enumerate(prompts):
        tokens[i] = p
    last = jnp.full((SLOTS,), PROMPT - 1, jnp.int32)

    def fwd():
        logits, kv = eng._prefill_jit(
            eng.params, jnp.asarray(tokens), last_pos=last
        )
        return logits

    logits = t("forward_dispatch+sync (bare, no writes)", fwd)

    # The engine's production path since round 4: forward + all 32 layers'
    # appends in ONE jitted dispatch (backends.prefill_and_write).
    def fwd_write():
        return eng._backend.prefill_and_write(
            eng._prefill_fn, eng.params, jnp.asarray(tokens),
            [PROMPT - 1] * SLOTS, list(range(SLOTS)), [PROMPT] * SLOTS,
            PROMPT,
        )

    logits = t("forward+append fused (production)", fwd_write)

    t("argmax_fetch", lambda: np.asarray(jnp.argmax(logits, axis=-1)))

    # full engine step (warm, includes the one decode step after activate)
    def full_round():
        rs = [eng.submit(p, max_new_tokens=2) for p in prompts]
        t0 = time.perf_counter()
        while eng.waiting or eng.prefilling:
            eng.step()
        jax.block_until_ready(eng.caches[0].k)
        dt = time.perf_counter() - t0
        eng.run_to_completion()
        return dt

    for i in range(3):
        dt = full_round()
        print(json.dumps({
            "phase": f"engine_prefill_round{i}",
            "ms": round(dt * 1e3, 1),
            "tok_s": round(SLOTS * PROMPT / dt, 1),
        }), flush=True)
    print(json.dumps({"stats": {k: int(v) for k, v in eng.stats.items()}}),
          flush=True)

    # Flagship round (64 slots x 128-token prompts -> TWO 32-request
    # groups): group 1's first-token fetch pipelines behind group 2's
    # forward (engine._pending_prefill), so this config shows the
    # overlap win; the single-group 16x256 round above cannot.
    del eng
    import gc
    gc.collect()
    eng64 = Engine(params, cfg, num_slots=64, max_len=512,
                   cache_dtype=jnp.int8, prefill_bucket=128)
    prompts64 = [
        [(7 * i + j) % 1000 + 1 for j in range(128)] for i in range(64)
    ]
    rs = [eng64.submit(p, max_new_tokens=2) for p in prompts64]
    eng64.run_to_completion()  # warm/compile
    for i in range(3):
        rs = [eng64.submit(p, max_new_tokens=2) for p in prompts64]
        t0 = time.perf_counter()
        while eng64.waiting or eng64.prefilling:
            eng64.step()
        jax.block_until_ready(eng64.caches[0].k)
        dt = time.perf_counter() - t0
        eng64.run_to_completion()
        print(json.dumps({
            "phase": f"engine_prefill64_round{i}",
            "ms": round(dt * 1e3, 1),
            "tok_s": round(64 * 128 / dt, 1),
        }), flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
