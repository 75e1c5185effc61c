"""The Triton kernels lower for CUDA at the benchmark widths.

``jax.export`` with ``platforms=["cuda"]`` runs the full Pallas -> Triton
IR lowering of each kernel here, without a card, so a kernel-authoring
error in any path fails on the CPU rather than first on the chip.  The fp8
paths are lowered with fp8 tensor cores on (as on Hopper) and must feed
e4m3 operands to the QK^T dot.
"""

import jax
import jax.numpy as jnp
import pytest

import quantumattention_tpu as qa
from quantumattention_tpu import config
from quantumattention_tpu.ops.decode import decode_attention
from quantumattention_tpu.ops.flash import flash_attention

TRITON = jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
B, H, S = 16, 16, 8192  # the reference protocol


def _export(fn, *avals):
    with config.patch({"interpret": False, "attention.fp8_dot": True}):
        exp = jax.export.export(
            jax.jit(fn), platforms=["cuda"], disabled_checks=[TRITON]
        )(*avals)
        text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    return exp


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for item in v if isinstance(v, (list, tuple)) else (v,):
                sub = getattr(item, "jaxpr", item)
                if hasattr(sub, "eqns"):
                    yield from _walk(sub)


def _qk_dot_dtypes(fn, *avals):
    with config.patch({"interpret": False, "attention.fp8_dot": True}):
        jaxpr = jax.make_jaxpr(fn)(*avals).jaxpr
    for eqn in _walk(jaxpr):
        if eqn.primitive.name == "pallas_call":
            for inner in _walk(eqn.params["jaxpr"]):
                if inner.primitive.name == "dot_general":
                    return tuple(str(v.aval.dtype) for v in inner.invars)
    raise AssertionError("no kernel dot")


PATHS = {
    "bf16": lambda q, k, v: qa.attn_func(q, k, v, is_causal=True),
    "fp8 head-wise": lambda q, k, v: qa.fp8_attn_func(q, k, v, is_causal=True),
    "fp8 token-wise": lambda q, k, v: qa.fp8_attn_func(
        q, k, v, is_causal=True, scaling_method="token-wise"),
    "fp8 per-block": lambda q, k, v: qa.fp8_attn_func(
        q, k, v, is_causal=True, scaling_method="per-block"),
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_flash_exports_for_cuda(head_dim, path):
    aval = jax.ShapeDtypeStruct((B, H, S, head_dim), jnp.bfloat16)
    _export(PATHS[path], aval, aval, aval)
    dots = _qk_dot_dtypes(PATHS[path], aval, aval, aval)
    want = "bfloat16" if path == "bf16" else "float8_e4m3fn"
    assert dots == (want, want)


def test_flash_gqa_window_residuals_export_for_cuda():
    q = jax.ShapeDtypeStruct((B, 32, S, 128), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((B, 8, S, 128), jnp.bfloat16)
    _export(
        lambda q, k, v: flash_attention(
            q, k, v, is_causal=True, window=(1024, 0), q_offset=jnp.int32(S),
            kv_offset=jnp.int32(0), return_residuals=True,
        ),
        q, kv, kv,
    )


@pytest.mark.parametrize("mode", ["int8", "bf16", "verify-window"])
def test_decode_exports_for_cuda(mode):
    batch, hq, hkv, seq, d = 64, 32, 8, 4096, 128
    tokens = (4,) if mode == "verify-window" else ()
    q = jax.ShapeDtypeStruct((batch, hq) + tokens + (d,), jnp.bfloat16)
    lengths = jax.ShapeDtypeStruct((batch,), jnp.int32)
    if mode == "bf16":
        cache = jax.ShapeDtypeStruct((batch, hkv, seq, d), jnp.bfloat16)
        _export(lambda q, k, v, n: decode_attention(q, k, v, n),
                q, cache, cache, lengths)
        return
    cache = jax.ShapeDtypeStruct((batch, hkv, seq, d), jnp.int8)
    scale = jax.ShapeDtypeStruct((batch, hkv, seq), jnp.float32)
    window = (1023, 0) if mode == "verify-window" else None
    _export(
        lambda q, k, v, ks, vs, n: decode_attention(
            q, k, v, n, k_scale=ks, v_scale=vs, window=window),
        q, cache, cache, scale, scale, lengths,
    )
