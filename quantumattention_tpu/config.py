"""Config/flag system for quantumattention_tpu.

JAX re-design of the reference's env-var-driven torch ConfigModule
(reference: src/quantum_attn/config.py:1-41): a tree of plain namespaces whose
defaults come from ``QUANTUM_ATTN_*`` environment variables, plus a
``patch()`` context manager with the same dotted-key semantics the reference's
tests rely on (reference: tests/test_interface.py:45-49).

Flags are read at *trace time* by the dispatcher, so inside ``jax.jit`` they
are baked into the compiled program — the JAX analogue of the reference's
``@torch.compiler.assume_constant_result`` gates (reference:
src/quantum_attn/utils/checks.py:9-15).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val not in ("0", "", "false", "False", "OFF", "off")


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


class _Namespace:
    """A mutable attribute namespace (one level of the config tree)."""

    def __init__(self, **kwargs: Any) -> None:
        for key, value in kwargs.items():
            setattr(self, key, value)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_Namespace({vars(self)})"


# ---------------------------------------------------------------------------
# Flag tree.  Mirrors the reference's flag surface (config.py:11-31).
# ---------------------------------------------------------------------------

#: Allow reduced-precision accumulation for the P@V matmul inside the fused
#: kernel.  Analogue of QUANTUM_ATTN_USE_FAST_ACCUM (reference config.py:11 /
#: inductor use at mm_common.py:79); the Hopper kernel keeps fp32
#: accumulation and does not read it.
use_fast_accum: bool = _env_bool("QUANTUM_ATTN_USE_FAST_ACCUM", False)

#: Kernel execution mode: "auto" compiles Pallas kernels on GPU and
#: interprets them on CPU; True forces interpret mode everywhere (debugging);
#: False forces compiled mode.
interpret: Any = _env_str("QUANTUM_ATTN_INTERPRET", "auto")

kernel = _Namespace(
    # Default Q-sequence tile of the flash kernel (a power of two). None =>
    # the per-head-dim default (ops/flash.default_tiles).
    block_q=None,
    # Default KV-sequence tile. None => the per-head-dim default.
    block_kv=None,
    # Use base-2 exponent domain for the online softmax (folds log2(e) into
    # the scale like the reference's exp2 softmax, tk/attention.py:238-240).
    use_exp2=True,
    # Round the probability tile to bf16 before the row sum and the PV
    # product (fp32 max-subtract and accumulators).  Off by default.
    softmax_bf16=_env_bool("QUANTUM_ATTN_SOFTMAX_BF16", False),
    # Enable the timed path tuner for fp8_attention(scaling_method="auto")
    # (shape-class keyed, disk cached), like the reference's compile-time
    # autotune_select_algorithm (attention.py:1034): the first call per
    # shape class pays a short timed sweep; every later call (and every
    # later process, via the disk cache) takes the cached winner.
    autotune=_env_bool("QUANTUM_ATTN_AUTOTUNE", True),
    # Also tune when first encountered inside jax.jit, by timing
    # synthesized same-shape buffers at trace time (autotune.synth_like).
    autotune_in_jit=_env_bool("QUANTUM_ATTN_AUTOTUNE_IN_JIT", True),
    # Side-buffer paged burst (serving/backends.PagedBackend
    # ._burst_impl_side): keep the page pool scan-INVARIANT across a
    # decode burst, append each step's tokens to a small per-layer side
    # buffer attended alongside the cache prefix, and flush once per
    # burst.  False = per-step scatter burst (also the int4/window path).
    paged_side_burst=_env_bool("QUANTUM_ATTN_PAGED_SIDE_BURST", True),
    # Causal two-stage decomposition inside the flash kernel (reference
    # inductor/kernels/attention.py:592-641): KV tiles wholly inside the
    # visible region run a loop with no mask code at all; only the edge
    # tiles (causal diagonal, window edges, ragged tail) are masked.
    causal_two_stage=_env_bool("QUANTUM_ATTN_CAUSAL_TWO_STAGE", True),
)

attention = _Namespace(
    # Skip the capability check in the dispatcher (reference config.py:27,
    # nn.py:292-295).
    skip_supported_check=_env_bool("QUANTUM_ATTN_SKIP_SUPPORTED_CHECK", False),
    # Route everything through the XLA SDPA reference path (reference's
    # force_eager_fallback, config.py:28).
    force_fallback=_env_bool("QUANTUM_ATTN_FORCE_FALLBACK", False),
    # Enable the fused Pallas flash kernel (analogue of
    # enable_tk_tma_kernel, config.py:29; default on).
    enable_pallas_kernel=_env_bool("QUANTUM_ATTN_ENABLE_PALLAS_KERNEL", True),
    # Run QK^T of pre-quantized int8 q/k as an int8 x int8 -> int32 dot
    # (False: upcast both to bf16).
    enable_int8_qk=_env_bool("QUANTUM_ATTN_ENABLE_INT8_QK", True),
    # Quantize-in-graph paths also store V as per-channel int8
    # (SageAttention-style), dequantized per KV tile in the kernel.  Off
    # by default.
    enable_int8_pv=_env_bool("QUANTUM_ATTN_ENABLE_INT8_PV", False),
    # fp8-native tensor-core matmul (e4m3 operands, fp32 accumulation — the
    # reference's fp8 WGMMA). "auto" gates on compute capability >= 9.0;
    # True forces it on (used by CPU interpret-mode tests), False forces
    # the exact upcast to bf16.
    fp8_dot=_env_str("QUANTUM_ATTN_FP8_DOT", "auto"),
    # Decode-kernel variants that run QK^T (decode_int8_qk) or PV
    # (decode_int8_pv) on int8 operands.  Off by default; the Hopper decode
    # kernel does not read them (removal: ROADMAP 3.5).
    decode_int8_qk=_env_bool("QUANTUM_ATTN_DECODE_INT8_QK", False),
    decode_int8_pv=_env_bool("QUANTUM_ATTN_DECODE_INT8_PV", False),
)


_MODULE = __import__(__name__, fromlist=["_"])


def _resolve(dotted: str):
    """Resolve "a.b" to (namespace_object, leaf_name)."""
    parts = dotted.split(".")
    obj: Any = _MODULE
    for part in parts[:-1]:
        obj = getattr(obj, part)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"unknown config key: {dotted!r}")
    return obj, leaf


def get(dotted: str) -> Any:
    obj, leaf = _resolve(dotted)
    return getattr(obj, leaf)


def set(dotted: str, value: Any) -> None:  # noqa: A001 - mirrors config API
    obj, leaf = _resolve(dotted)
    setattr(obj, leaf, value)


@contextlib.contextmanager
def patch(changes: Dict[str, Any] | None = None, **kw: Any) -> Iterator[None]:
    """Temporarily override config values by dotted key.

    Mirrors the reference's ``quantum_attn.config.patch({...})`` context
    manager semantics (reference: tests/test_interface.py:45-49).
    """
    merged: Dict[str, Any] = dict(changes or {})
    merged.update(kw)
    saved = {key: get(key) for key in merged}
    try:
        for key, value in merged.items():
            set(key, value)
        yield
    finally:
        for key, value in saved.items():
            set(key, value)
