"""Model-level serving benchmark: end-to-end tokens/s at Llama-3-8B shapes.

BASELINE.md's decode target is "tokens/s at Llama-3-8B attention shapes,
FP8 paged KV cache, continuous batching" — bench.py measures the attention
KERNEL at those shapes; this script measures the whole serving stack: the
Engine driving a 32-layer 8B-shape decoder (w8a16 int8 weights), fused fp8
prefill attention, int8 token-wise-quantized KV cache, and burst decode
(many steps chained in one jitted scan, one dispatch per burst).

Weights are initialized DIRECTLY in int8 (models/quantized.
init_quantized_params) — random, not trained; decode cost is independent of
weight values, so tokens/s is representative while logits are not.

Phases reported:
  * prefill: N prompts x S_in tokens through the fused fp8 prefill path,
    engine-stepped (mixed-scheduler admission included);
  * decode: pure-decode burst phase, all slots active, until every request
    hits max_new_tokens.

Usage: python benchmarks/model_bench.py [--slots 16] [--prompt 512]
       [--new 1024] [--burst 64]   (on a GPU; one process)
The persistent compile cache makes reruns start hot.
"""

import argparse
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


def main():
    p = argparse.ArgumentParser()
    # Defaults: 8 GB int8 weights + an int8 KV cache of slots*max_len
    # (2.15 GB at 16x1024).  (new - 1) is kept a multiple of
    # burst so the measured run reuses exactly the warmed burst program.
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--prompt", type=int, default=256)
    p.add_argument("--new", type=int, default=705)
    p.add_argument("--burst", type=int, default=64)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--model", default="llama3_8b")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (logic smoke, not a benchmark)")
    p.add_argument("--no-fuse", action="store_true",
                   help="keep separate wq/wk/wv and gate/up matmuls")
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from quantumattention_tpu.models import llama, quantized
    from quantumattention_tpu.serving.engine import Engine

    cfg = getattr(llama, args.model)()
    print(
        f"model={args.model} layers={cfg.num_layers} hidden={cfg.hidden_size} "
        f"Hq={cfg.num_q_heads} Hkv={cfg.num_kv_heads} D={cfg.head_dim} "
        f"vocab={cfg.vocab_size}",
        flush=True,
    )

    t0 = time.perf_counter()
    params = quantized.init_quantized_params(jax.random.PRNGKey(0), cfg)
    if not args.no_fuse:
        # One [wq|wk|wv] and one [gate|up] matmul per layer: the per-op
        # fixed dispatch cost dominates decode (op_overhead_probe.py).
        params = quantized.fuse_projections(params)
    # Force materialization so weight init doesn't bleed into phase timing.
    jax.block_until_ready(params)
    nbytes = sum(
        x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(params)
    )
    print(
        f"int8 weights ready: {nbytes / 1e9:.2f} GB "
        f"in {time.perf_counter() - t0:.0f}s",
        flush=True,
    )

    eng = Engine(
        params, cfg,
        num_slots=args.slots, max_len=args.max_len, cache_dtype=jnp.int8,
        prefill_bucket=args.prompt,
    )

    key = jax.random.PRNGKey(1)
    prompts = [
        [int(t) for t in jax.random.randint(
            jax.random.fold_in(key, i), (args.prompt,), 0, cfg.vocab_size
        )]
        for i in range(args.slots)
    ]

    # --- warm/compile pass (small budgets, same programs: one batched
    # prefill + exactly one full burst — burst+1 new tokens because the
    # first token comes from prefill logits) ---
    t0 = time.perf_counter()
    warm = [eng.submit(pr, max_new_tokens=args.burst + 1) for pr in prompts]
    eng.run_to_completion(decode_burst=args.burst)
    assert all(r.done for r in warm)
    print(f"warm/compile pass: {time.perf_counter() - t0:.0f}s", flush=True)

    # --- measured runs: 3 rounds, report the best (chip throughput
    # drifts ~1.5x across time even within a process window — CLAUDE.md;
    # identical decode code has measured 26-40 ms/step in different
    # single-shot runs) ---
    prefill_times, decode_times = [], []
    for _ in range(3):
        reqs = [eng.submit(pr, max_new_tokens=args.new) for pr in prompts]

        t0 = time.perf_counter()
        while eng.waiting or eng.prefilling:
            eng.step()
        # step() is async; the prefill phase must be fenced explicitly.
        jax.block_until_ready(eng.caches[0].k)
        prefill_times.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        eng.run_to_completion(decode_burst=args.burst)
        decode_times.append(time.perf_counter() - t0)
        assert all(r.done and len(r.output) == args.new for r in reqs)

    t_prefill = min(prefill_times)
    t_decode = min(decode_times)
    prefill_tokens = args.slots * args.prompt
    # First token of each request comes from prefill logits; the decode
    # phase produces the rest.
    decode_tokens = args.slots * args.new - args.slots
    prefill_tps = prefill_tokens / t_prefill
    decode_tps = decode_tokens / t_decode
    step_ms = t_decode / (args.new - 1) * 1e3

    print(
        json.dumps(
            {
                "metric": "model_serving_tokens_per_s",
                "value": round(decode_tps, 1),
                "unit": "tok/s",
                "detail": {
                    "model": args.model,
                    "weights": "int8 w8a16",
                    "fused_projections": not args.no_fuse,
                    "kv_cache": "int8 token-wise",
                    "slots": args.slots,
                    "prompt_tokens": args.prompt,
                    "new_tokens": args.new,
                    "decode_burst": args.burst,
                    "prefill_tokens_per_s": round(prefill_tps, 1),
                    "prefill_s": round(t_prefill, 2),
                    "decode_step_ms": round(step_ms, 2),
                    "decode_s": round(t_decode, 2),
                    "decode_s_all": [round(t, 2) for t in decode_times],
                    "prefill_s_all": [round(t, 2) for t in prefill_times],
                    "engine_stats": dict(eng.stats),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
