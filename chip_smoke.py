"""Bring-up smoke run of quantumattention_tpu on NVIDIA GPUs.

Drives the library and the serving engine once through their public entry
points, compiled for the card, and checks every result against the plain
float32 reference.  Any failure exits nonzero; nothing is caught.

    python chip_smoke.py             # one card: phases 0-4
    python chip_smoke.py --chips 4   # four cards: TP-4 serving + ring SP-4

Phases (one card):
  0. device: a GPU, its name and power limit;
  1. attention library at B=16, H=16, S=8192: D in {64, 128, 256} x
     {causal, full} x {bf16, fp8 head-wise, token-wise, per-block}, GQA
     32/8 with a window, and residuals with offsets — each compiled,
     compared with the fp32 reference, and timed beside cuDNN bf16;
  2. decode kernel against its plain XLA version, full-length and ragged;
  3. engine: Llama-3-8B at full width serving 16 requests;
  4. paged backend with a prefix cache, w8a16 weights, speculative
     decoding, one training step.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

RMSE_BOUND = 1e-2  # the reference's accuracy bar (BASELINE.md)


def card_line() -> str:
    """Name and power limit of the card, read by nvidia-smi in a child
    process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _sub_jaxprs(params):
    for v in params.values():
        for item in v if isinstance(v, (list, tuple)) else (v,):
            if hasattr(item, "eqns"):
                yield item
            elif hasattr(item, "jaxpr") and hasattr(item.jaxpr, "eqns"):
                yield item.jaxpr


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from _walk(sub)


def kernel_dot_dtypes(fn, args, name):
    """Operand dtypes of the dots inside the Pallas kernel ``name``."""
    import jax

    found = []
    for eqn in _walk(jax.make_jaxpr(fn)(*args).jaxpr):
        if eqn.primitive.name != "pallas_call":
            continue
        if str(eqn.params["name"]) != name:
            continue
        for inner in _walk(eqn.params["jaxpr"]):
            if inner.primitive.name == "dot_general":
                found.append(tuple(str(v.aval.dtype) for v in inner.invars))
    return found


def assert_compiled_kernel(fn, args, name):
    """The lowered program calls the Triton kernel ``name``: compiled for
    the card, not interpreted (an interpreted pallas_call lowers to plain
    HLO loops with no kernel call)."""
    import jax

    text = jax.jit(fn).lower(*args).as_text()
    assert "__gpu$xla.gpu.triton" in text, f"{name}: no GPU kernel call"
    assert kernel_dot_dtypes(fn, args, name), f"{name}: kernel not traced"


def assert_plain(fn, args):
    import jax

    text = jax.jit(fn).lower(*args).as_text()
    assert "__gpu$xla.gpu.triton" not in text
    assert "dot_general" in text


def device_rmse(a, b):
    import jax.numpy as jnp

    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return float(jnp.sqrt(jnp.mean(d * d)))


def time_call(fn, args, reps=5):
    from quantumattention_tpu import autotune

    return autotune.time_call(fn, args, reps=reps)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(jax):
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
            file=sys.stderr,
        )
        sys.exit(2)
    card = card_line()
    log(
        f"[0] device: {devices[0].device_kind} x{len(devices)} | "
        f"nvidia-smi: {card}"
    )
    return card


def attention_reference(q, k, v, is_causal, window=None):
    """fp32 attention at precision highest, one head at a time."""
    import jax
    import jax.numpy as jnp

    from quantumattention_tpu.ops.sdpa import sdpa_per_head

    ref_window = (window[0], None) if (window and is_causal) else window
    f = jax.jit(
        lambda q, k, v: sdpa_per_head(
            q.astype(jnp.float32), k.astype(jnp.float32),
            v.astype(jnp.float32), is_causal=is_causal, window=ref_window,
            out_dtype=jnp.float32,
        )
    )
    return f(q, k, v)


def phase_attention(card, batch=16, heads=16, seq=8192, dims=(64, 128, 256)):
    import jax
    import jax.numpy as jnp

    import quantumattention_tpu as qa
    from quantumattention_tpu.ops.flash import flash_attention

    paths = {
        "bf16": lambda c: (lambda q, k, v: qa.attn_func(q, k, v, is_causal=c)),
        "fp8 head-wise": lambda c: (lambda q, k, v: qa.fp8_attn_func(
            q, k, v, is_causal=c, scaling_method="head-wise")),
        "fp8 token-wise": lambda c: (lambda q, k, v: qa.fp8_attn_func(
            q, k, v, is_causal=c, scaling_method="token-wise")),
        "fp8 per-block": lambda c: (lambda q, k, v: qa.fp8_attn_func(
            q, k, v, is_causal=c, scaling_method="per-block")),
    }
    worst = 0.0
    for d in dims:
        kq, kk, kv = jax.random.split(jax.random.PRNGKey(d), 3)
        shape = (batch, heads, seq, d)
        q, k, v = (
            jax.random.normal(key, shape, jnp.float32).astype(jnp.bfloat16)
            for key in (kq, kk, kv)
        )
        for causal in (True, False):
            ref = attention_reference(q, k, v, causal)
            flops = 4 * batch * heads * seq * seq * d / (2 if causal else 1)
            cudnn = jax.jit(
                lambda q, k, v, c=causal: jax.nn.dot_product_attention(
                    q, k, v, is_causal=c, implementation="cudnn"
                )
            )
            qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
            t_cudnn = time_call(cudnn, (qt, kt, vt))
            cudnn_err = device_rmse(cudnn(qt, kt, vt).transpose(0, 2, 1, 3), ref)
            for name, make in paths.items():
                fn = make(causal)
                assert_compiled_kernel(fn, (q, k, v), "qa_flash_fwd")
                dots = kernel_dot_dtypes(fn, (q, k, v), "qa_flash_fwd")
                if name in ("fp8 head-wise", "fp8 token-wise", "fp8 per-block"):
                    # QK^T on e4m3 operands: the fp8 tensor cores.
                    assert dots[0] == ("float8_e4m3fn", "float8_e4m3fn"), dots
                jfn = jax.jit(fn)
                err = device_rmse(jfn(q, k, v), ref)
                assert err < RMSE_BOUND, (d, causal, name, err)
                worst = max(worst, err)
                t = time_call(jfn, (q, k, v))
                log(
                    f"[1] attn D={d} {'causal' if causal else 'full  '} "
                    f"{name:15s} {t * 1e3:8.3f} ms {flops / t / 1e12:7.1f} "
                    f"TFLOP/s | cuDNN bf16 {t_cudnn * 1e3:8.3f} ms "
                    f"{flops / t_cudnn / 1e12:7.1f} TFLOP/s "
                    f"(rmse {cudnn_err:.2e}) | rmse {err:.3e} < {RMSE_BOUND} "
                    f"| qk dot {dots[0][0]} | {card}"
                )
            del ref

    # GQA 32/8 with a sliding window.
    d, hq, hkv, window = 128, 32, 8, (1024, 0)
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(kq, (batch, hq, seq, d), jnp.float32).astype(jnp.bfloat16)
    k = jax.random.normal(kk, (batch, hkv, seq, d), jnp.float32).astype(jnp.bfloat16)
    v = jax.random.normal(kv, (batch, hkv, seq, d), jnp.float32).astype(jnp.bfloat16)
    ref = attention_reference(q, k, v, True, window)
    for name, fn in (
        ("bf16", lambda q, k, v: qa.attn_func(q, k, v, is_causal=True,
                                              window=window)),
        ("fp8 head-wise", lambda q, k, v: qa.fp8_attn_func(
            q, k, v, is_causal=True, window=window)),
    ):
        assert_compiled_kernel(fn, (q, k, v), "qa_flash_fwd")
        jfn = jax.jit(fn)
        err = device_rmse(jfn(q, k, v), ref)
        assert err < RMSE_BOUND, ("gqa-window", name, err)
        worst = max(worst, err)
        t = time_call(jfn, (q, k, v))
        log(
            f"[1] attn GQA {hq}/{hkv} D={d} causal window={window} {name:15s} "
            f"{t * 1e3:8.3f} ms | rmse {err:.3e} < {RMSE_BOUND} | {card}"
        )

    # Residuals with position offsets: q placed after the whole KV block,
    # so the causal mask is a no-op and the output equals full attention.
    q, k, v = q[:, :8], k[:, :8], v[:, :8]

    def with_res(q, k, v):
        return flash_attention(
            q, k, v, is_causal=True, q_offset=jnp.int32(seq),
            kv_offset=jnp.int32(0), return_residuals=True,
        )

    assert_compiled_kernel(with_res, (q, k, v), "qa_flash_fwd")
    out, (m, l) = jax.jit(with_res)(q, k, v)
    ref = attention_reference(q, k, v, False)
    err = device_rmse(out, ref)
    assert err < RMSE_BOUND, ("residuals", err)
    assert m.shape == l.shape == q.shape[:3]
    assert bool(jnp.all(jnp.isfinite(m))) and bool(jnp.all(l >= 1.0))
    worst = max(worst, err)
    log(
        f"[1] attn residuals+offsets D={d}: rmse {err:.3e} < {RMSE_BOUND}, "
        f"m/l {m.shape} finite | {card}"
    )
    return worst


def phase_decode(card, batch=64, seq=4096):
    import jax
    import jax.numpy as jnp

    from quantumattention_tpu.ops import quant
    from quantumattention_tpu.ops.decode import (
        decode_attention, decode_attention_plain,
    )
    hq, hkv, d = 32, 8, 128
    kq, kk, kv, kl = jax.random.split(jax.random.PRNGKey(11), 4)
    q = jax.random.normal(kq, (batch, hq, d), jnp.float32).astype(jnp.bfloat16)
    k8, ks = quant.quantize_token_wise(
        jax.random.normal(kk, (batch, hkv, seq, d), jnp.float32), jnp.int8)
    v8, vs = quant.quantize_token_wise(
        jax.random.normal(kv, (batch, hkv, seq, d), jnp.float32), jnp.int8)
    kf = k8.astype(jnp.float32) * ks[..., None]
    vf = v8.astype(jnp.float32) * vs[..., None]

    @jax.jit
    def reference(q, kf, vf, lengths):
        # One query row attends to the first lengths[b] cache rows.
        valid = jnp.arange(seq)[None, None, :] < lengths[:, None, None]
        g = hq // hkv
        kr = jnp.repeat(kf, g, axis=1)
        vr = jnp.repeat(vf, g, axis=1)
        s = jnp.einsum("bhd,bhsd->bhs", q.astype(jnp.float32), kr,
                       precision=jax.lax.Precision.HIGHEST) / math.sqrt(d)
        s = jnp.where(valid, s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhs,bhsd->bhd", p, vr,
                          precision=jax.lax.Precision.HIGHEST)

    kernel = jax.jit(lambda q, k, v, ks, vs, n: decode_attention(
        q, k, v, n, k_scale=ks, v_scale=vs))
    plain = jax.jit(lambda q, k, v, ks, vs, n: decode_attention_plain(
        q, k, v, n, k_scale=ks, v_scale=vs))
    cases = {
        "full": jnp.full((batch,), seq, jnp.int32),
        "half": jnp.full((batch,), seq // 2, jnp.int32),
        "ragged": jax.random.randint(kl, (batch,), 1, seq + 1, jnp.int32),
    }
    timings = {}
    for name, lengths in cases.items():
        args = (q, k8, v8, ks, vs, lengths)
        assert_compiled_kernel(kernel, args, "qa_decode_split")
        assert_plain(plain, args)
        ref = reference(q, kf, vf, lengths)
        e_k = device_rmse(kernel(*args), ref)
        e_p = device_rmse(plain(*args), ref)
        assert e_k < RMSE_BOUND and e_p < RMSE_BOUND, (name, e_k, e_p)
        t_k = time_call(kernel, args, reps=20)
        t_p = time_call(plain, args, reps=20)
        timings[name] = (t_k, t_p)
        log(
            f"[2] decode B={batch} Hq={hq} Hkv={hkv} S={seq} D={d} int8 "
            f"{name:6s} (mean len {float(jnp.mean(lengths)):.0f}): kernel "
            f"{t_k * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms | rmse kernel "
            f"{e_k:.3e} plain {e_p:.3e} < {RMSE_BOUND} | {card}"
        )
    return timings


def _prompts(n, length, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n, length)).tolist()


def _rel_rmse(a, b):
    import jax.numpy as jnp

    a, b = a.astype(jnp.float32), b.astype(jnp.float32)
    return float(jnp.sqrt(jnp.mean((a - b) ** 2)) / jnp.std(b))


def _serve(engine, prompts, new_tokens, decode_burst):
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    t0 = time.perf_counter()
    engine.run_to_completion(decode_burst=decode_burst)
    wall = time.perf_counter() - t0
    for r in reqs:
        assert r.done and len(r.output) == new_tokens, (r.id, len(r.output))
    return reqs, wall


#: Bound on the relative logits RMSE of the served model (bf16 weights and
#: activations, fp8 attention, 32 layers) against its float32 forward at
#: precision highest.
LOGITS_BOUND = 0.15


def phase_engine(card, cfg=None, num_slots=16, max_len=2048, prompt_len=512,
                 new_tokens=64):
    """Llama-3-8B at full width through the serving engine."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from quantumattention_tpu.models import llama
    from quantumattention_tpu.serving.engine import Engine

    cfg = cfg or llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    jax.block_until_ready(params)
    log(f"[3] params: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype.__name__} "
        f"({time.perf_counter() - t0:.1f} s)")

    prompts = _prompts(num_slots, prompt_len, cfg.vocab_size, seed=1)
    engine = Engine(params, cfg, num_slots=num_slots, max_len=max_len)
    reqs, wall = _serve(engine, prompts, new_tokens, decode_burst=16)
    log(f"[3] engine: {len(reqs)} requests x ({prompt_len} prompt + "
        f"{new_tokens} new) tokens served in {wall:.2f} s incl. compile | "
        f"stats {engine.stats} | {card}")

    # First tokens against the model's own prefill forward, outside the
    # engine (greedy sampling = argmax).
    tokens = jnp.asarray(prompts, jnp.int32)
    last = jnp.full((num_slots,), prompt_len - 1, jnp.int32)
    logits, _ = jax.jit(
        lambda p, t, lp: llama.forward_prefill(p, t, cfg, last_pos=lp)
    )(params, tokens, last)
    want = [int(t) for t in jnp.argmax(logits, axis=-1)]
    got = [r.output[0] for r in reqs]
    assert got == want, (got, want)
    log(f"[3] first tokens of all {num_slots} requests == argmax of "
        "llama.forward_prefill outside the engine")

    # The served model's logits against its float32 reference forward.
    ref_cfg = dataclasses.replace(cfg, dtype=jnp.float32, attention_impl="sdpa")
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, t: llama.forward(p, t, ref_cfg))(
            jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params),
            tokens[:1],
        )
    model = jax.jit(lambda p, t: llama.forward(p, t, cfg))(params, tokens[:1])
    err = _rel_rmse(model, ref)
    agree = float(jnp.mean(jnp.argmax(model, -1) == jnp.argmax(ref, -1)))
    assert err < LOGITS_BOUND, err
    del ref
    log(f"[3] logits vs fp32 sdpa forward (precision highest), one prompt: "
        f"relative rmse {err:.3e} < {LOGITS_BOUND}, top-1 agreement "
        f"{agree:.3f}")

    backend = engine._backend
    mem = backend._decode_jit.lower(
        params, backend.caches, jnp.zeros((num_slots,), jnp.int32),
        jnp.ones((num_slots,), bool),
    ).compile().memory_analysis()
    log(f"[3] decode step memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[3] peak_bytes_in_use {stats.get('peak_bytes_in_use')} | {card}")
    return params


def phase_other_paths(card, params, cfg=None, prefix_len=384, tail_len=128,
                      new_tokens=16):
    """Paged + prefix cache, w8a16, speculative decoding, a train step."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from quantumattention_tpu.models import llama, quantized
    from quantumattention_tpu.serving.engine import Engine

    cfg = cfg or llama.llama3_8b()
    shared = _prompts(1, prefix_len, cfg.vocab_size, seed=2)[0]
    tails = _prompts(4, tail_len, cfg.vocab_size, seed=3)
    prompts = [shared + t for t in tails]

    paged = Engine(params, cfg, num_slots=4, max_len=1024,
                   cache_backend="paged", prefix_cache=True,
                   prefill_chunk=tail_len, page_size=min(128, tail_len))
    _, wall = _serve(paged, prompts[:1], new_tokens, decode_burst=None)
    _, wall2 = _serve(paged, prompts[1:], new_tokens, decode_burst=None)
    assert paged.stats["prefix_hits"] >= 3, paged.stats
    log(f"[4] paged + prefix cache: 4 requests sharing {prefix_len} tokens "
        f"served ({wall + wall2:.2f} s incl. compile) | stats {paged.stats}")
    del paged

    qparams = quantized.fuse_projections(
        quantized.init_quantized_params(jax.random.PRNGKey(0), cfg)
    )
    w8 = Engine(qparams, cfg, num_slots=4, max_len=1024)
    reqs, wall = _serve(w8, prompts, new_tokens, decode_burst=None)
    tokens = jnp.asarray(prompts[:1], jnp.int32)
    err = _rel_rmse(
        jax.jit(lambda p, t: llama.forward(p, t, cfg))(qparams, tokens),
        jax.jit(lambda p, t: llama.forward(p, t, cfg))(params, tokens),
    )
    assert err < LOGITS_BOUND, err
    log(f"[4] w8a16 (fused projections): 4 requests served ({wall:.2f} s "
        f"incl. compile); logits vs bf16 weights relative rmse {err:.3e} "
        f"< {LOGITS_BOUND}")
    del w8, qparams

    draft_cfg = dataclasses.replace(
        cfg, num_layers=2, hidden_size=1024, intermediate_size=2048,
        num_q_heads=8, num_kv_heads=8,
    )
    draft = llama.init_params(jax.random.PRNGKey(5), draft_cfg)
    spec = Engine(params, cfg, num_slots=4, max_len=1024,
                  draft=(draft, draft_cfg), spec_tokens=4)
    _, wall = _serve(spec, prompts, new_tokens, decode_burst=None)
    log(f"[4] speculative decoding (2-layer draft, 4 tokens a round): 4 "
        f"requests served ({wall:.2f} s incl. compile) | proposed "
        f"{spec.stats['spec_proposed']} accepted {spec.stats['spec_accepted']}")
    del spec

    tiny = llama.tiny()
    tparams = llama.init_params(jax.random.PRNGKey(6), tiny)
    batch = jax.random.randint(jax.random.PRNGKey(7), (2, 64), 0, tiny.vocab_size)
    new, loss = jax.jit(lambda p, b: llama.train_step(p, b, tiny))(tparams, batch)
    assert bool(jnp.isfinite(loss))
    moved = float(jnp.max(jnp.abs(
        new["layers"][0]["wq"].astype(jnp.float32)
        - tparams["layers"][0]["wq"].astype(jnp.float32))))
    assert moved > 0.0
    log(f"[4] llama.train_step on llama.tiny: loss {float(loss):.4f}, "
        f"weights moved (max |dw| {moved:.2e}) | {card}")


def phase_multi_card(card, cfg=None, seq=32768, num_slots=4, prompt_len=256,
                     new_tokens=8):
    """TP-4 serving of Llama-3-70B and ring attention at sp=4."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from quantumattention_tpu.models import llama
    from quantumattention_tpu.ops.flash import flash_attention
    from quantumattention_tpu.parallel import mesh as qmesh
    from quantumattention_tpu.parallel.ring import ring_attention
    from quantumattention_tpu.serving import tp as tp_lib
    from quantumattention_tpu.serving.engine import Engine

    n = len(jax.devices())
    assert n == 4, f"--chips 4 needs four devices, found {n}"
    # Llama-3-70B at full width; depth cut to 8 of 80 layers.
    cfg = cfg or llama.llama3_70b(num_layers=8)
    mesh = qmesh.make_mesh((n,), ("tp",))
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), qmesh.llama_param_specs(cfg),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec),
    )
    t0 = time.perf_counter()
    params = jax.jit(
        lambda key: llama.init_params(key, cfg), out_shardings=shardings
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    log(f"[5] params initialised into TP-{n} shardings: {cfg.num_layers} "
        f"layers, hidden {cfg.hidden_size} ({time.perf_counter() - t0:.1f} s)")

    prompts = _prompts(num_slots, prompt_len, cfg.vocab_size, seed=8)
    engine = Engine(params, cfg, num_slots=num_slots, max_len=1024, mesh=mesh)
    reqs, wall = _serve(engine, prompts, new_tokens, decode_burst=8)
    tokens = jnp.asarray(prompts, jnp.int32)
    last = jnp.full((num_slots,), prompt_len - 1, jnp.int32)
    tp_logits, _ = jax.jit(
        lambda p, t, lp: tp_lib.forward_prefill_tp(
            p, t, cfg=cfg, mesh=mesh, last_pos=lp)
    )(params, tokens, last)
    gspmd_logits, _ = jax.jit(
        lambda p, t, lp: llama.forward_prefill(p, t, cfg, last_pos=lp)
    )(params, tokens, last)
    err = _rel_rmse(tp_logits, gspmd_logits)
    assert err < 1e-2, err
    want = [int(t) for t in jnp.argmax(gspmd_logits, -1)]
    got = [r.output[0] for r in reqs]
    assert got == want, (got, want)
    log(f"[5] TP-{n} engine (Llama-3-70B widths): {num_slots} requests x "
        f"({prompt_len} + {new_tokens}) served in {wall:.2f} s incl. compile; "
        f"first-token logits vs GSPMD forward relative rmse {err:.3e} < 1e-2; "
        f"first tokens == GSPMD argmax | {card}")
    del engine, params

    sp_mesh = qmesh.make_mesh((n,), ("sp",))
    heads, d = 8, 128
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    q, k, v = (
        jax.random.normal(key, (1, heads, seq, d), jnp.float32).astype(jnp.bfloat16)
        for key in keys
    )
    single = jax.jit(
        lambda q, k, v: flash_attention(q, k, v, is_causal=True)
    )(q, k, v)
    spec = NamedSharding(sp_mesh, jax.sharding.PartitionSpec(None, None, "sp", None))
    qs, ks, vs = (jax.device_put(x, spec) for x in (q, k, v))
    ring = jax.jit(
        lambda q, k, v: ring_attention(q, k, v, mesh=sp_mesh, is_causal=True)
    )
    out = ring(qs, ks, vs)
    err = device_rmse(out, single)
    assert err < RMSE_BOUND, err
    t_ring = time_call(ring, (qs, ks, vs))
    t_one = time_call(
        jax.jit(lambda q, k, v: flash_attention(q, k, v, is_causal=True)),
        (q, k, v),
    )
    log(f"[5] ring attention sp={n} S={seq} H={heads} D={d} causal: rmse vs "
        f"one card's fused output {err:.3e} < {RMSE_BOUND}; ring "
        f"{t_ring * 1e3:.3f} ms, one card {t_one * 1e3:.3f} ms | {card}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--chips", type=int, default=1, choices=(1, 4),
        help="4 runs only the paths that span four cards",
    )
    parser.add_argument(
        "--phases", default="0,1,2,3,4",
        help="comma-separated one-card phases to run (default: all)",
    )
    args = parser.parse_args(argv)

    import jax

    from quantumattention_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = phase_device(jax)
    phases = {int(p) for p in args.phases.split(",")}
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_multi_card(card)
        phases = set()
    if 1 in phases:
        worst = phase_attention(card)
        log(f"[1] attention done: worst rmse {worst:.3e} "
            f"({time.perf_counter() - t0:.0f} s)")
    if 2 in phases:
        phase_decode(card)
        log(f"[2] decode done ({time.perf_counter() - t0:.0f} s)")
    if phases & {3, 4}:
        params = phase_engine(card)
        log(f"[3] engine done ({time.perf_counter() - t0:.0f} s)")
        if 4 in phases:
            phase_other_paths(card, params)
            log(f"[4] other paths done ({time.perf_counter() - t0:.0f} s)")
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
