"""Attention benchmark harness — prints ONE JSON line.

Mirrors the reference's benchmark protocol (reference:
tests/test_interface.py:90-156): shape B=16, H=16, S=8192, D=128,
FLOPs = 4*B*H*S_Q*S_KV*D (halved if causal), TFLOP/s reported.

Measured paths:
  * cuDNN's fused bf16 attention through
    ``jax.nn.dot_product_attention(implementation="cudnn")`` — the
    analogue of the reference's FlashAttention-SDPA baseline
    (tests/test_interface.py:127-129);
  * bf16 fused Pallas flash kernel (this repo);
  * FP8 head-wise and per-block fused paths, in-graph dynamic quantization
    included (vs_baseline = best / cuDNN bf16);
  * int8-KV decode attention at Llama-3-8B shapes;
  * Llama-3-8B serving through the engine (unless --no-serving).

Timing: host clock around ``block_until_ready``, median of ``--iters``
calls after a warm-up call.  Needs an NVIDIA GPU; fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def card_line() -> str:
    """Name and power limit of the card (nvidia-smi, a child process)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bench_one(fn, args, iters: int) -> float:
    """Median seconds per call of jit(fn)(*args)."""
    from quantumattention_tpu import autotune

    return autotune.time_call(jax.jit(fn), tuple(args), reps=iters)


def serve_point(params, cfg, num_slots, max_len, prompt, new_tokens=257):
    """(decode tok/s, ms per decode step, prefill tok/s) of one engine
    operating point; round 0 compiles, round 1 measures."""
    from quantumattention_tpu.serving.engine import Engine

    eng = Engine(params, cfg, num_slots=num_slots, max_len=max_len,
                 cache_dtype=jnp.int8, prefill_bucket=prompt)
    prompts = [[(7 * i + j) % 1000 + 1 for j in range(prompt)]
               for i in range(num_slots)]
    pre = dec = float("inf")
    for _ in range(2):
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        t0 = time.perf_counter()
        while eng.waiting or eng.prefilling:
            eng.step()
        jax.block_until_ready(eng.caches[0].k)
        pre = min(pre, time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng.run_to_completion(decode_burst=64)
        dec = min(dec, time.perf_counter() - t0)
        assert all(r.done and len(r.output) == new_tokens for r in reqs)
    steps = new_tokens - 1
    return (num_slots * steps / dec, dec / steps * 1e3,
            num_slots * prompt / pre)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--heads", type=int, default=16)
    parser.add_argument("--seq", type=int, default=8192)
    parser.add_argument("--head-dim", type=int, default=128)
    parser.add_argument("--causal", action="store_true")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--no-serving", action="store_true",
                        help="skip the model-level serving measurement")
    parser.add_argument(
        "--full", action="store_true",
        help="also emit the full reference benchmark matrix "
        "(D in {64,128,256} x causal x {bf16, fp8 head-wise, per-block})",
    )
    args = parser.parse_args()

    from quantumattention_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    card = card_line()

    import quantumattention_tpu as qa

    b, h, s, d = args.batch, args.heads, args.seq, args.head_dim
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(key, (b, h, s, d), jnp.float32)
               .astype(jnp.bfloat16) for key in keys)
    flops = 4 * b * h * s * s * d // (2 if args.causal else 1)

    def cudnn(q, k, v):
        return jax.nn.dot_product_attention(
            q, k, v, is_causal=args.causal, implementation="cudnn")

    qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    t_cudnn = bench_one(cudnn, (qt, kt, vt), args.iters)
    t_bf16 = bench_one(
        lambda q, k, v: qa.attn_func(q, k, v, is_causal=args.causal),
        (q, k, v), args.iters)
    t_fp8 = bench_one(
        lambda q, k, v: qa.fp8_attn_func(q, k, v, is_causal=args.causal),
        (q, k, v), args.iters)
    t_pb = bench_one(
        lambda q, k, v: qa.fp8_attn_func(
            q, k, v, is_causal=args.causal, scaling_method="per-block"),
        (q, k, v), args.iters)

    # Decode: int8 KV cache at Llama-3-8B attention shapes.
    from quantumattention_tpu.ops.decode import decode_attention
    from quantumattention_tpu.ops.quant import dynamically_quantize_int8

    dB, dHq, dHkv, dD, dS = 64, 32, 8, 128, 4096
    dk = jax.random.split(jax.random.PRNGKey(1), 3)
    dq = jax.random.normal(dk[0], (dB, dHq, dD), jnp.float32).astype(jnp.bfloat16)
    kc8, kcs = dynamically_quantize_int8(
        jax.random.normal(dk[1], (dB, dHkv, dS, dD), jnp.float32))
    vc8, vcs = dynamically_quantize_int8(
        jax.random.normal(dk[2], (dB, dHkv, dS, dD), jnp.float32))
    t_dec = bench_one(
        lambda q, k, v, ks, vs, n: decode_attention(
            q, k, v, n, k_scale=ks, v_scale=vs),
        (dq, kc8, vc8, kcs, vcs, jnp.full((dB,), dS, jnp.int32)),
        max(args.iters, 20))

    serving = {}
    if not args.no_serving:
        del q, k, v, qt, kt, vt
        from quantumattention_tpu.models import llama, quantized

        cfg8 = llama.llama3_8b()
        params8 = quantized.fuse_projections(
            quantized.init_quantized_params(jax.random.PRNGKey(0), cfg8))
        tok64, ms64, pre64 = serve_point(params8, cfg8, 64, 512, 128)
        tok16, ms16, pre16 = serve_point(params8, cfg8, 16, 1024, 256)
        serving = {
            "serving_decode_tok_s_8b_64slots": tok64,
            "serving_decode_ms_per_step_64slots": ms64,
            "serving_decode_tok_s_8b_16slots": tok16,
            "serving_decode_ms_per_step": ms16,
            "serving_prefill_tok_s_8b": pre16,
            "serving_prefill_tok_s_8b_64slots": pre64,
        }
        del params8

    matrix = {}
    if args.full:
        for d_full in (64, 128, 256):
            mk = jax.random.split(jax.random.PRNGKey(2), 3)
            qf, kf, vf = (jax.random.normal(key, (b, h, s, d_full), jnp.float32)
                          .astype(jnp.bfloat16) for key in mk)
            for name, scaling in (("bf16", None), ("fp8_headwise", "head-wise"),
                                  ("per_block", "per-block")):
                for causal in (False, True):
                    if scaling is None:
                        fn = lambda q, k, v, c=causal: qa.attn_func(
                            q, k, v, is_causal=c)
                    else:
                        fn = lambda q, k, v, c=causal, m=scaling: (
                            qa.fp8_attn_func(q, k, v, is_causal=c,
                                             scaling_method=m))
                    t_m = bench_one(fn, (qf, kf, vf), args.iters)
                    fl = 4 * b * h * s * s * d_full // (2 if causal else 1)
                    matrix[f"d{d_full}_{name}_{'causal' if causal else 'full'}"] = (
                        fl / t_m / 1e12)
            del qf, kf, vf

    tflops = {name: flops / t / 1e12 for name, t in (
        ("cudnn", t_cudnn), ("bf16", t_bf16), ("fp8", t_fp8), ("pb", t_pb))}
    best = max(tflops["bf16"], tflops["fp8"], tflops["pb"])
    print(f"# device: {dev.device_kind} x{len(jax.devices())} | {card}")
    print(json.dumps({
        "metric": "fused_attention_throughput_best",
        "value": best,
        "unit": "TFLOP/s",
        "vs_baseline": best / tflops["cudnn"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "detail": {
            "fp8_headwise_tflops": tflops["fp8"],
            "fp8_per_block_tflops": tflops["pb"],
            "bf16_flash_tflops": tflops["bf16"],
            "cudnn_bf16_tflops": tflops["cudnn"],
            "decode_int8kv_tokens_per_s_8b_shapes": dB / t_dec,
            **({"matrix": matrix} if matrix else {}),
            **serving,
        },
    }))


if __name__ == "__main__":
    main()
