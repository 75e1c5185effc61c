"""Public functional API.

Name-for-name JAX re-expression of the reference's user-facing surface
(reference: src/quantum_attn/quantum_attn_interface.py):

  attn_func / attn_func_with_fallback                   (:41-98)
  fp8_attn_func / fp8_attn_func_with_fallback           (:101-176)
  fp8_token_wise_attn_func / ..._with_fallback          (:179-248)

The reference registers the ``*_with_fallback`` variants as dispatchable
``CompositeImplicitAutograd`` torch ops so they decompose inside
``torch.compile`` (:21-34).  In JAX there is nothing to register: every
function here is pure and traceable, so they inline into any enclosing
``jax.jit`` for free — the "always-correct, opportunistically-fast" contract
(SURVEY.md §3.3) is preserved by doing the capability check on abstract
shapes/dtypes at trace time and baking in exactly one branch.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from . import dispatch

__all__ = [
    "attn_func",
    "attn_func_with_fallback",
    "fp8_attn_func",
    "fp8_attn_func_with_fallback",
    "fp8_token_wise_attn_func",
    "fp8_token_wise_attn_func_with_fallback",
]

Window = Optional[Tuple[Optional[int], Optional[int]]]


def attn_func(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    window: Window = None,
    q_segment_ids: Any = None,
    kv_segment_ids: Any = None,
    block_mask: Any = None,
):
    """Fused bf16/fp16 attention (reference quantum_attn_interface.py:41-59).

    Raises ``ValueError`` when the fused kernel cannot serve the inputs.
    Segment ids enable packed-sequence (multi-document) masking, and
    ``block_mask`` (a (ceil(Sq/128), ceil(Skv/128)) granule bitmap) enables
    splash-style block-sparse attention — extensions over the reference
    (whose masks stop at causal + ragged tails, tk/attention.py:252-272).
    """
    return dispatch.attention(
        query,
        key,
        value,
        attn_mask,
        dropout_p,
        is_causal,
        scale=scale,
        window=window,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        block_mask=block_mask,
    )


def attn_func_with_fallback(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    window: Window = None,
    dropout_key: Any = None,
):
    """``attn_func`` that silently degrades to the XLA SDPA path
    (reference quantum_attn_interface.py:62-98)."""
    supported, _ = dispatch.can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, window=window,
    )
    if supported:
        return attn_func(
            query, key, value, attn_mask, dropout_p, is_causal,
            scale=scale, window=window,
        )
    return dispatch.sdpa_fallback(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, window=window, dropout_key=dropout_key,
    )


def fp8_attn_func(
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
    window: Window = None,
):
    """FP8 fused attention, default head-wise scales
    (reference quantum_attn_interface.py:101-127).

    ``scaling_method``: "head-wise" (default; reference parity),
    "token-wise" (reference parity), "per-block" (in-kernel fused
    quantization — beyond the reference), or "auto" (backend-path
    autotune across {bf16, head-wise, per-block}, the analogue of the
    reference tuning across TK/Triton/aten backends).
    """
    return dispatch.fp8_attention(
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


def fp8_attn_func_with_fallback(
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
    window: Window = None,
    dropout_key: Any = None,
):
    """``fp8_attn_func`` with graceful degradation
    (reference quantum_attn_interface.py:130-176).

    The fallback dequantizes pre-quantized inputs through the oracle-defined
    semantics (reference ops.py:64-95) so it is correct for any scale shape.
    """
    if scaling_method is None:
        scaling_method = "head-wise"
    supported, _ = dispatch.can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method=scaling_method, window=window,
    )
    # Pre-quantization path: inputs are still float and will be quantized
    # in-graph, which is always shape-compatible; validate post-quant shape
    # by checking with synthetic scale ranks instead.
    if supported or (
        scale_q is None
        and dispatch.can_use_attention(
            query, key, value, attn_mask, dropout_p, is_causal,
            scale=scale, window=window,
        )[0]
    ):
        return fp8_attn_func(
            query, key, value, attn_mask, dropout_p, is_causal,
            scale=scale, scale_q=scale_q, scale_k=scale_k,
            scaling_method=scaling_method, window=window,
        )
    return dispatch.sdpa_fallback(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        window=window, dropout_key=dropout_key,
    )


def fp8_token_wise_attn_func(
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
    window: Window = None,
):
    """FP8 attention pinned to token-wise scaling
    (reference quantum_attn_interface.py:179-202)."""
    return fp8_attn_func(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method="token-wise", window=window,
    )


def fp8_token_wise_attn_func_with_fallback(
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
    window: Window = None,
    dropout_key: Any = None,
):
    """Token-wise FP8 attention with graceful degradation
    (reference quantum_attn_interface.py:205-248)."""
    return fp8_attn_func_with_fallback(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method="token-wise", window=window, dropout_key=dropout_key,
    )
