"""Quantify the int4-KV operating point (VERDICT r3 item 9).

int4 KV halves cache bytes but measured SLOWER than int8 per step at
equal batch (1.17 vs 0.87 ms at B=64/S=4096 — the in-kernel unpack is
VPU-bound, not DMA-bound).  The open question: does int4 win TOKENS/S at
the batch int8 cannot hold?  This measures the kernel at the capacity
frontier and prints the HBM math for the model-level story:

  8B model, 32 layers, S=4096 KV rows/slot:
    int8 KV = 268 MB/slot-GB... per slot: 8 heads x 4096 x 128 x 2 = 8 MB
    -> per layer per slot 8 MB, x32 layers = 268 MB/slot.
    64 slots int8 = 17.2 GB  (does NOT fit beside any weights on 16 GB)
    64 slots int4 =  8.6 GB  (fits beside a 4.3 GB int4-weight tree)

Usage: python benchmarks/int4_operating_point.py  (on a GPU; one process)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from quantumattention_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from quantumattention_tpu.ops.decode import decode_attention
from quantumattention_tpu.ops.quant import (
    dynamically_quantize_int4,
    dynamically_quantize_int8,
)
from quantumattention_tpu.utils.profiling import bench

Hq, Hkv, D, S = 32, 8, 128, 4096


def measure(B, kind):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(B), 3)
    q = jax.random.normal(k1, (B, Hq, D), jnp.bfloat16)
    kraw = jax.random.normal(k2, (B, Hkv, S, D), jnp.float32)
    vraw = jax.random.normal(k3, (B, Hkv, S, D), jnp.float32)
    qz = dynamically_quantize_int4 if kind == "int4" else (
        dynamically_quantize_int8
    )
    kc, ks = qz(kraw)
    vc, vs = qz(vraw)
    del kraw, vraw
    lens = jnp.full((B,), S, jnp.int32)
    t = bench(
        lambda q, k, v, ks, vs, l: decode_attention(
            q, k, v, l, k_scale=ks, v_scale=vs
        ),
        (q, kc, vc, ks, vs, lens),
        iters=256,
    )
    bytes_step = 2 * B * Hkv * S * (D // (2 if kind == "int4" else 1))
    bytes_step += 2 * B * Hkv * S * 4  # fp32 scales stream too
    out = {
        "config": f"{kind}_B{B}",
        "ms_per_step": round(t * 1e3, 3),
        "tok_s": round(B / t, 1),
        "cache_gb_per_layer": round(
            2 * B * Hkv * S * (D // (2 if kind == "int4" else 1)) / 2**30, 2
        ),
        "gb_s": round(bytes_step / t / 1e9, 1),
    }
    print(json.dumps(out), flush=True)
    return out


rows = []
for rnd in range(2):  # within-process round-robin
    for B, kind in ((64, "int8"), (64, "int4"), (128, "int4"),
                    (128, "int8")):
        rows.append(measure(B, kind))

best = {}
for r in rows:
    c = r["config"]
    if c not in best or r["tok_s"] > best[c]["tok_s"]:
        best[c] = r
print("SUMMARY " + json.dumps(best), flush=True)

# Model-level capacity math (8B, 32 layers, S=4096 rows/slot)
per_slot_layer = Hkv * S * D * 2  # k+v bytes int8
for kind, div, wgb in (("int8", 1, 8.5), ("int4", 2, 4.3)):
    for slots in (16, 32, 64):
        cache_gb = per_slot_layer / div * slots * 32 / 2**30
        fits = cache_gb + wgb < 15.0
        print(json.dumps({
            "capacity": f"{kind}_kv_{kind}_w", "slots": slots,
            "cache_gb": round(cache_gb, 1), "weights_gb": wgb,
            "fits_16gb": fits,
        }), flush=True)
print("DONE", flush=True)
