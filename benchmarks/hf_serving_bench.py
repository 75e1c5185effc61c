"""Serve a REAL on-disk HF checkpoint end-to-end (VERDICT r4 item 2).

Loads a full-size Llama-3-8B-architecture checkpoint directory
(config.json + sharded bf16 safetensors — benchmarks/make_hf_checkpoint.py
synthesizes one at exact HF layout) through ``Engine.from_hf`` with
streaming int8 quantization (models/hf.params_from_hf(quantize=...)), then
runs the flagship serving measurement (64 slots, prompt 128, 256 new
tokens, burst 64 — the benchmarks/model_grid.py protocol).  Reports load
time, device-memory footprint, and decode/prefill throughput as JSON
lines.

Usage: python benchmarks/hf_serving_bench.py [--ckpt _checkpoints/llama3_8b_synth]
       (on a GPU; one process)
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


def device_mem_gib():
    try:
        stats = jax.local_devices()[0].memory_stats()
        return round(stats["bytes_in_use"] / 2**30, 2)
    except Exception:
        return None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="_checkpoints/llama3_8b_synth")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--new", type=int, default=257)
    ap.add_argument("--burst", type=int, default=64)
    ap.add_argument("--quantize", default="int8")
    args = ap.parse_args()

    from quantumattention_tpu.serving.engine import Engine

    t0 = time.perf_counter()
    eng = Engine.from_hf(
        args.ckpt,
        quantize_weights=args.quantize,
        fuse_projections=True,
        num_slots=args.slots,
        max_len=args.max_len,
        cache_dtype=jnp.int8,
        prefill_bucket=args.prompt,
    )
    jax.block_until_ready(eng.params)
    load_s = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "phase": "load",
                "load_s": round(load_s, 1),
                "device_mem_gib": device_mem_gib(),
                "quantize": args.quantize,
            }
        ),
        flush=True,
    )

    prompts = [
        [(7 * i + j) % 1000 + 1 for j in range(args.prompt)]
        for i in range(args.slots)
    ]
    best_pre = best_dec = float("inf")
    for rnd in range(3):  # round 0 warms/compiles; best of the rest
        reqs = [eng.submit(p, max_new_tokens=args.new) for p in prompts]
        t0 = time.perf_counter()
        while eng.waiting or eng.prefilling:
            eng.step()
        jax.block_until_ready(eng.caches[0].k)
        pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.run_to_completion(decode_burst=args.burst)
        dec = time.perf_counter() - t0
        assert all(r.done and len(r.output) == args.new for r in reqs)
        if rnd > 0:
            best_pre = min(best_pre, pre)
            best_dec = min(best_dec, dec)
        print(
            json.dumps(
                {
                    "phase": f"round{rnd}",
                    "prefill_s": round(pre, 2),
                    "decode_s": round(dec, 2),
                    "device_mem_gib": device_mem_gib(),
                }
            ),
            flush=True,
        )

    steps = args.new - 1
    print(
        json.dumps(
            {
                "config": "from_hf_8b",
                "slots": args.slots,
                "max_len": args.max_len,
                "prompt": args.prompt,
                "burst": args.burst,
                "load_s": round(load_s, 1),
                "decode_ms_per_step": round(best_dec / steps * 1e3, 2),
                "decode_tok_s": round(args.slots * steps / best_dec, 1),
                "prefill_tok_s": round(args.slots * args.prompt / best_pre, 1),
                "device_mem_gib": device_mem_gib(),
            }
        ),
        flush=True,
    )
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
