"""Dispatch / validation / quantization drivers.

JAX re-design of the reference's L4 layer (reference: src/quantum_attn/nn.py).
The reference's job at this layer is:

  * validate inputs per backend and produce machine-readable reason strings
    (reference nn.py:52-205, reasons aggregated at nn.py:299-307);
  * gate on device capability + config flags, constant-folded during tracing
    (reference nn.py:208-280);
  * quantize dynamically in-graph when scales are not supplied
    (reference nn.py:394-430);
  * wrap the op in the compiler (reference nn.py:373-391,518-539).

In JAX the compiler wrapping collapses away: every function here is plain
traceable JAX, so the user's enclosing ``jax.jit`` *is* the compile path and
validation runs once at trace time on abstract values.  The backend choice
list (reference's TK kernel → Triton kernel → aten, attention.py:888-1034)
becomes {Pallas fused kernel, XLA SDPA reference}.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from . import config
from .ops import autodiff, quant
from .ops.flash import MAX_HEAD_DIM, flash_attention
from .ops.sdpa import sdpa_reference
from .utils import checks

#: Head dims the fused Pallas kernel accepts.  The reference pins {64,128,256}
#: (nn.py:45-49,127-132); we additionally accept any multiple of 8 up to 256,
#: which the kernel zero-pads to the next power of two.
SUPPORTED_HEAD_DIMS = (64, 128, 256)

_FLOAT_QK_DTYPES = (jnp.bfloat16, jnp.float16, jnp.float32)


def _dtype_ok_qk(dtype) -> bool:
    return (
        dtype in _FLOAT_QK_DTYPES
        or checks.is_fp8_dtype(dtype)
        or dtype == jnp.int8
    )


def validate_flash_input(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Any = None,
    scale_k: Any = None,
    scaling_method: Optional[str] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> Tuple[bool, str]:
    """Shape/dtype/feature validation for the fused Pallas kernel.

    The analogue of ``_validate_tk_tma_input`` / ``_validate_triton_tma_sdpa_input``
    (reference nn.py:52-205).  Returns ``(ok, reason)``; reason is "" when ok.
    Unlike the reference, GQA and sliding windows are in the fast path, and an
    explicit softmax ``scale`` is supported (the reference rejects it,
    nn.py:74-75).
    """
    if attn_mask is not None:
        return False, "attn_mask is not supported by the fused kernel"
    if dropout_p != 0.0:
        return False, "dropout is not supported by the fused kernel"
    for name, t in (("query", query), ("key", key), ("value", value)):
        if t.ndim != 4:
            return False, f"{name} must be 4-D (B, H, S, D), got {t.ndim}-D"
    b_q, h_q, s_q, d_q = query.shape
    b_k, h_k, s_k, d_k = key.shape
    b_v, h_v, s_v, d_v = value.shape
    if not (b_q == b_k == b_v):
        return False, f"batch mismatch: {b_q}, {b_k}, {b_v}"
    if h_k != h_v:
        return False, f"key/value head mismatch: {h_k} vs {h_v}"
    if h_q % h_k != 0:
        return False, (
            f"num query heads ({h_q}) must be a multiple of kv heads ({h_k})"
        )
    if s_k != s_v:
        return False, f"key/value length mismatch: {s_k} vs {s_v}"
    if d_q != d_k:
        return False, f"query/key head_dim mismatch: {d_q} vs {d_k}"
    if d_q != d_v:
        return False, f"query/value head_dim mismatch: {d_q} vs {d_v}"
    if d_q > MAX_HEAD_DIM:
        return False, (
            f"head_dim {d_q} > {MAX_HEAD_DIM} exceeds the kernel's register "
            "tile (routed to the XLA path)"
        )
    if d_q not in SUPPORTED_HEAD_DIMS and d_q % 8 != 0:
        return False, (
            f"head_dim {d_q} unsupported (want one of {SUPPORTED_HEAD_DIMS} "
            f"or a multiple of 8 <= {MAX_HEAD_DIM})"
        )
    if is_causal and window is not None and window[1] not in (None, 0):
        return False, "is_causal with a right window extent is contradictory"

    if not _dtype_ok_qk(query.dtype):
        return False, f"query dtype {query.dtype} unsupported"
    if not _dtype_ok_qk(key.dtype):
        return False, f"key dtype {key.dtype} unsupported"
    if not (
        value.dtype in _FLOAT_QK_DTYPES or checks.is_fp8_dtype(value.dtype)
    ):
        return False, f"value dtype {value.dtype} unsupported"

    has_scales = scale_q is not None or scale_k is not None
    if (scale_q is None) != (scale_k is None):
        return False, "scale_q and scale_k must be provided together"
    if checks.is_8bit_dtype(query.dtype) or checks.is_8bit_dtype(key.dtype):
        if query.dtype == jnp.int8 and not has_scales:
            return False, "int8 query/key require scale_q/scale_k"
    if has_scales:
        if scale_q.ndim not in (2, 3):
            return False, (
                "scales must be head-wise (B, H) or token-wise (B, H, S), "
                f"got rank {scale_q.ndim}"
            )
        if scale_q.ndim != scale_k.ndim:
            return False, "scale_q/scale_k rank mismatch"
        expected = {"head-wise": 2, "token-wise": 3}.get(scaling_method)
        if expected is not None and scale_q.ndim != expected:
            return False, (
                f"scaling_method={scaling_method!r} expects rank-{expected} "
                f"scales, got rank {scale_q.ndim}"
            )
        if scale_q.shape[:2] != (b_q, h_q):
            return False, (
                f"scale_q leading dims {scale_q.shape[:2]} != (B, Hq) "
                f"({b_q}, {h_q})"
            )
        if scale_k.shape[:2] != (b_k, h_k):
            return False, (
                f"scale_k leading dims {scale_k.shape[:2]} != (B, Hkv) "
                f"({b_k}, {h_k})"
            )
        if scale_q.ndim == 3 and (
            scale_q.shape[2] != s_q or scale_k.shape[2] != s_k
        ):
            return False, "token-wise scale length mismatch"
    return True, ""


def can_use_attention(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Any = None,
    scale_k: Any = None,
    scaling_method: Optional[str] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> Tuple[bool, str]:
    """Aggregate capability check with self-explaining reason strings.

    Mirrors the reference's ``can_use_attention`` contract (nn.py:282-307):
    ``skip_supported_check`` short-circuits; otherwise each backend's refusal
    reason is collected into one bracketed string.
    """
    if config.attention.skip_supported_check:
        return True, ""
    if config.attention.force_fallback:
        return False, "[pallas: disabled by config.attention.force_fallback]"
    reasons = []
    if config.attention.enable_pallas_kernel:
        ok, reason = validate_flash_input(
            query,
            key,
            value,
            attn_mask,
            dropout_p,
            is_causal,
            scale=scale,
            scale_q=scale_q,
            scale_k=scale_k,
            scaling_method=scaling_method,
            window=window,
        )
        if ok:
            return True, ""
        reasons.append(f"[pallas: {reason}]")
    else:
        reasons.append("[pallas: disabled by config.attention.enable_pallas_kernel]")
    return False, " ".join(reasons)


def attention(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    q_segment_ids: Any = None,
    kv_segment_ids: Any = None,
    block_mask: Any = None,
):
    """bf16/fp16 fused attention driver (reference nn.py:325-391).

    Raises ``ValueError`` with the aggregated reason when the fused kernel
    cannot serve the inputs — callers wanting graceful degradation use the
    ``*_with_fallback`` entry points instead.
    """
    supported, reason = can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, window=window,
    )
    if not supported:
        raise ValueError(f"attention is not supported for the input: {reason}")
    if (
        checks.is_8bit_dtype(query.dtype)
        or checks.is_8bit_dtype(key.dtype)
        or q_segment_ids is not None
        or block_mask is not None
    ):
        # Pre-quantized operands are not differentiable, and the VJP
        # wrapper does not thread segment ids / sparse masks; use the raw
        # kernel (forward-only, like every reference path).
        return flash_attention(
            query, key, value, is_causal=is_causal, sm_scale=scale,
            window=window, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, block_mask=block_mask,
        )
    return autodiff.attention_with_vjp(
        query, key, value, is_causal=is_causal, sm_scale=scale, window=window
    )


def _quantize_for(
    t: Any, scaling_method: str, qdtype
) -> Tuple[Any, Any]:
    """In-graph dynamic quantization (reference nn.py:410-418)."""
    if scaling_method == "head-wise":
        return quant.quantize_head_wise(t, qdtype)
    if scaling_method == "token-wise":
        return quant.quantize_token_wise(t, qdtype)
    raise ValueError(f"unknown scaling_method: {scaling_method!r}")


def fp8_attention(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Any = None,
    scale_k: Any = None,
    scaling_method: Optional[str] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
):
    """FP8 fused attention driver (reference nn.py:433-539).

    When ``scale_q``/``scale_k`` are not supplied, Q and K are dynamically
    quantized in-graph at the requested granularity (reference
    ``_fp8_attention_wrapper``, nn.py:394-430) — XLA fuses the amax/scale/cast
    chain with the surrounding computation.  The quantization container is
    fp8 e4m3, which the kernel feeds to the fp8 tensor cores on Hopper.
    """
    if scaling_method is None:
        scaling_method = "head-wise"
    if scaling_method not in ("head-wise", "token-wise", "per-block", "auto"):
        raise ValueError(f"unknown scaling_method: {scaling_method!r}")

    if (scale_q is None) != (scale_k is None):
        raise ValueError("scale_q and scale_k must be provided together")

    if scaling_method == "auto":
        # Backend/path autotune (the analogue of the reference tuning
        # across TK / Triton / aten backends, attention.py:888-1034): time
        # {bf16 flash, head-wise 8-bit, per-block 8-bit} once per shape
        # class and dispatch to the cached winner.
        if scale_q is not None:
            raise ValueError(
                "scaling_method='auto' tunes the quantization path; "
                "do not pass scale_q/scale_k"
            )
        if checks.is_8bit_dtype(query.dtype) or checks.is_8bit_dtype(key.dtype):
            raise ValueError("scaling_method='auto' expects float q/k")
        scaling_method = _tuned_path(
            query, key, value, is_causal, scale, window
        )
        if scaling_method == "none":
            return attention(
                query, key, value, attn_mask, dropout_p, is_causal,
                scale=scale, window=window,
            )
        if scaling_method == "sdpa":
            # The XLA-native path won the timed sweep (it can at tiny
            # shapes, where the fused kernel's fixed per-call cost
            # dominates — the analogue of the reference's aten extern
            # fallback choice, attention.py:1015-1031).
            return sdpa_fallback(
                query, key, value, attn_mask, dropout_p, is_causal,
                scale=scale, window=window,
            )

    if scaling_method == "per-block" and scale_q is not None:
        raise ValueError("per-block scaling quantizes in-kernel; "
                         "do not pass scale_q/scale_k")

    float_inputs = scale_q is None and not checks.is_8bit_dtype(query.dtype)
    if float_inputs:
        # Quantize-in-graph path.  Validate on the float shapes, then run
        # the quantized forward through a straight-through-estimator VJP so
        # models using the fp8 path stay trainable (the quantization casts
        # themselves have no useful gradient; STE is the standard QAT
        # treatment).
        supported, reason = can_use_attention(
            query, key, value, attn_mask, dropout_p, is_causal,
            scale=scale, window=window,
        )
        if not supported:
            raise ValueError(
                f"fp8_attention is not supported for the input: {reason}"
            )
        statics = _Fp8Statics(
            scaling_method=scaling_method,
            is_causal=is_causal,
            scale=scale,
            window=window,
        )
        return _fp8_attention_diff(statics, query, key, value)

    # Pre-quantized inputs: forward-only (like the reference).
    supported, reason = can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method=scaling_method, window=window,
    )
    if not supported:
        raise ValueError(
            f"fp8_attention is not supported for the input: {reason}"
        )
    return flash_attention(
        query,
        key,
        value,
        scale_q=scale_q,
        scale_k=scale_k,
        is_causal=is_causal,
        sm_scale=scale,
        window=window,
    )


def _tuned_path(query, key, value, is_causal, scale, window) -> str:
    """Pick the fastest of {bf16 flash, head-wise 8-bit, per-block 8-bit}
    for this shape class — "none" means run unquantized.

    Eager calls time the real inputs; traced calls synthesize same-shape
    device buffers (autotune.synth_like) so the tune still happens at
    trace time, exactly once per shape class, winner persisted to disk.
    """
    from . import autotune

    batch, hq, q_len, head_dim = query.shape
    hkv, kv_len = key.shape[1], key.shape[2]
    pkey = autotune.shape_key(
        "path", batch, hq, hkv, q_len, kv_len, head_dim, is_causal,
        query.dtype,
    )
    if window is not None:
        pkey += f"|w{window[0]}_{window[1]}"
    hit = autotune.lookup(pkey)
    if isinstance(hit, str):
        return hit
    default = "per-block"
    if not config.kernel.autotune or checks.resolve_interpret(config.interpret):
        return default
    if isinstance(query, jax.core.Tracer):
        if not config.kernel.autotune_in_jit or jax.process_count() > 1:
            return default
        # Synthesis AND the timing sweep below must escape the ambient
        # trace — run on a fresh thread (trace state is thread-local;
        # autotune.run_outside_trace explains why ensure_compile_time_
        # eval cannot compile pallas kernels).
        def _synth_and_sweep():
            q2, k2, v2 = (autotune.synth_like(t) for t in (query, key, value))
            return _sweep_paths(q2, k2, v2, is_causal, scale, window, pkey)

        return autotune.run_outside_trace(_synth_and_sweep)
    return _sweep_paths(query, key, value, is_causal, scale, window, pkey)


def _sweep_paths(query, key, value, is_causal, scale, window, pkey):
    from . import autotune

    def runner(method):
        if method == "none":
            fn = jax.jit(
                lambda q, k, v: flash_attention(
                    q, k, v, is_causal=is_causal, sm_scale=scale,
                    window=window,
                )
            )
        elif method == "sdpa":
            # XLA-native fallback as a timed candidate (the reference lets
            # autotune pick the aten extern kernel too,
            # attention.py:1015-1031) — it can win at tiny shapes where the
            # fused kernel's fixed per-call cost dominates.
            fn = jax.jit(
                lambda q, k, v: sdpa_fallback(
                    q, k, v, is_causal=is_causal, scale=scale, window=window
                )
            )
        else:
            statics = _Fp8Statics(method, is_causal, scale, window)
            fn = jax.jit(lambda q, k, v: _fp8_forward(statics, q, k, v))
        return fn, (query, key, value)

    return autotune.tune(
        pkey, runner, ("none", "head-wise", "per-block", "sdpa")
    )


class _Fp8Statics(NamedTuple):
    scaling_method: str
    is_causal: bool
    scale: Optional[float]
    window: Optional[Tuple[Optional[int], Optional[int]]]


def _fp8_forward(statics: "_Fp8Statics", query, key, value):
    """Quantize-in-graph fp8 fused forward on float inputs."""
    if statics.scaling_method == "per-block":
        # In-kernel fused quantization: per-(Q-tile/KV-tile) scalar
        # scales computed on the fly (finer granularity than head-wise,
        # no preprocessing passes).
        return flash_attention(
            query, key, value, fused_block_quant=True,
            is_causal=statics.is_causal, sm_scale=statics.scale,
            window=statics.window,
        )
    q8, scale_q = _quantize_for(query, statics.scaling_method, jnp.float8_e4m3fn)
    k8, scale_k = _quantize_for(key, statics.scaling_method, jnp.float8_e4m3fn)
    scale_v = None
    if config.attention.enable_int8_pv and not checks.is_8bit_dtype(value.dtype):
        value, scale_v = quant.quantize_channel_wise(value, jnp.int8)
    return flash_attention(
        q8,
        k8,
        value,
        scale_q=scale_q,
        scale_k=scale_k,
        scale_v=scale_v,
        is_causal=statics.is_causal,
        sm_scale=statics.scale,
        window=statics.window,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _fp8_attention_diff(statics: _Fp8Statics, query, key, value):
    return _fp8_forward(statics, query, key, value)


def _fp8_diff_fwd(statics, query, key, value):
    return _fp8_forward(statics, query, key, value), (query, key, value)


def _fp8_diff_bwd(statics, residuals, g):
    """STE backward for the quantize-in-graph path: the gradient of exact
    (unquantized) attention at the float inputs, computed one head at a
    time by the plain VJP (``autodiff.oracle_vjp``)."""
    query, key, value = residuals
    return autodiff.oracle_vjp(
        query, key, value, g, is_causal=statics.is_causal,
        sm_scale=statics.scale, window=statics.window,
    )


_fp8_attention_diff.defvjp(_fp8_diff_fwd, _fp8_diff_bwd)


def sdpa_fallback(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Any = None,
    scale_k: Any = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    dropout_key: Any = None,
):
    """The always-correct XLA path (reference's torch_sdpa fallback,
    quantum_attn_interface.py:18,90-98)."""
    out_dtype = value.dtype
    if checks.is_8bit_dtype(out_dtype):
        out_dtype = jnp.bfloat16
    return sdpa_reference(
        query,
        key,
        value,
        attn_mask=attn_mask,
        dropout_p=dropout_p,
        is_causal=is_causal,
        scale=scale,
        scale_q=scale_q,
        scale_k=scale_k,
        window=window,
        dropout_key=dropout_key,
        out_dtype=out_dtype,
    )
