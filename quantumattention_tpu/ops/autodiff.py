"""Differentiable attention: custom VJP around the fused forward kernel.

The reference is forward-only by design (its LSE output is commented out,
reference: src/quantum_attn/tk/attention.py:333-346, and its custom ops are
registered without autograd).  This build adds training support: the fused
Pallas kernel serves the forward pass, and a ``jax.custom_vjp`` supplies
gradients as the VJP of the plain fp32 attention (the numerical-semantics
definition of the op, reference ops.py:17-29), computed one head at a time
(``sdpa_per_head``) so only one head's logits are ever live.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax

from .flash import flash_attention
from .sdpa import sdpa_per_head


class AttnStatics(NamedTuple):
    """Hashable static configuration for the differentiable attention op."""

    is_causal: bool = False
    sm_scale: Optional[float] = None
    window: Optional[Tuple[Optional[int], Optional[int]]] = None
    block_q: Optional[int] = None
    block_kv: Optional[int] = None


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _attn(statics: AttnStatics, q, k, v):
    return flash_attention(
        q,
        k,
        v,
        is_causal=statics.is_causal,
        sm_scale=statics.sm_scale,
        window=statics.window,
        block_q=statics.block_q,
        block_kv=statics.block_kv,
    )


def _attn_fwd(statics: AttnStatics, q, k, v):
    return _attn(statics, q, k, v), (q, k, v)


def oracle_vjp(q, k, v, g, *, is_causal, sm_scale, window):
    """Gradients of exact attention at (q, k, v), one head at a time."""
    if is_causal and window is not None:
        # The kernel treats a right extent as inactive under causal masking
        # (flash.py); mirror that in the recompute.
        window = (window[0], None)

    def oracle(q, k, v):
        return sdpa_per_head(
            q, k, v, is_causal=is_causal, scale=sm_scale, window=window,
            out_dtype=v.dtype,
        )

    _, vjp = jax.vjp(oracle, q, k, v)
    return vjp(g.astype(v.dtype))


def _attn_bwd(statics: AttnStatics, residuals, g):
    q, k, v = residuals
    return oracle_vjp(
        q, k, v, g, is_causal=statics.is_causal, sm_scale=statics.sm_scale,
        window=statics.window,
    )


_attn.defvjp(_attn_fwd, _attn_bwd)


def attention_with_vjp(
    q,
    k,
    v,
    *,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
):
    """Fused-forward attention with gradients (training-capable).

    Same contract as ``flash_attention`` for bf16/fp16 inputs; gradients flow
    to q, k, and v (GQA gradients sum over the sharing group via the oracle's
    ``jnp.repeat`` graph).
    """
    statics = AttnStatics(
        is_causal=is_causal,
        sm_scale=sm_scale,
        window=window,
        block_q=block_q,
        block_kv=block_kv,
    )
    return _attn(statics, q, k, v)


def quantize_ste(quantize_fn, t):
    """Straight-through estimator around a quantizer.

    Forward: ``quantize_fn(t) -> (t_q, scale)``.  Backward: identity into
    ``t`` (the standard STE used for quantization-aware training).  Lets the
    FP8 path participate in training graphs.
    """

    @jax.custom_vjp
    def _q(x):
        return quantize_fn(x)

    def _q_fwd(x):
        return quantize_fn(x), None

    def _q_bwd(_, g):
        g_values, _g_scale = g
        return (g_values.astype(t.dtype),)

    _q.defvjp(_q_fwd, _q_bwd)
    return _q(t)
