"""Capability / feature gates.

JAX analogue of the reference's version & CUDA-capability predicates
(reference: src/quantum_attn/utils/checks.py:9-75).  The axes that matter
are which backend the arrays live on (``gpu`` compiles the Pallas kernels,
``cpu`` interprets them for tests), the GPU's compute capability (fp8
tensor cores from 9.0 on, the reference's Hopper gate), and the JAX
version.

All predicates are pure Python evaluated at trace time, so under ``jax.jit``
they constant-fold — the JAX analogue of the reference's
``assume_constant_result`` wrappers (checks.py:9-15).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.cache
def jax_version_tuple() -> tuple:
    return tuple(int(p) for p in jax.__version__.split(".")[:3])


def jax_version_at_least(major: int, minor: int, patch: int = 0) -> bool:
    return jax_version_tuple() >= (major, minor, patch)


@functools.cache
def default_backend() -> str:
    return jax.default_backend()


def is_cpu_backend() -> bool:
    return default_backend() == "cpu"


@functools.cache
def gpu_compute_capability() -> tuple:
    """(major, minor) compute capability of the first GPU, () off a GPU.

    Read from the device's ``compute_capability`` attribute ("9.0" on an
    H100/H200), the same attribute jaxlib's Triton lowering reads.
    """
    if default_backend() != "gpu":
        return ()
    cc = jax.devices()[0].compute_capability
    return tuple(int(p) for p in str(cc).split("."))


def supports_fp8_tensor_cores() -> bool:
    """Whether the GPU multiplies fp8 e4m3 operands natively (CC >= 9.0).

    The reference's Hopper gate for its fp8 WGMMA kernel (reference
    checks.py:61-64, tk/attention.py:233).
    """
    return gpu_compute_capability() >= (9, 0)


def fp8_dot_enabled() -> bool:
    """Resolve config.attention.fp8_dot ("auto" => compute-capability gate).

    Forcing it on (config.patch({"attention.fp8_dot": True})) lets CPU
    interpret-mode tests exercise the fp8-native dot that compiled kernels
    take on Hopper.
    """
    from .. import config

    mode = config.attention.fp8_dot
    if mode == "auto":
        return supports_fp8_tensor_cores()
    return bool(mode)


def supports_fp8_storage() -> bool:
    """float8_e4m3fn arrays are supported by this jax/backend."""
    try:
        jnp.zeros((1,), jnp.float8_e4m3fn)
        return True
    except TypeError:  # pragma: no cover
        return False


def is_fp8_dtype(dtype) -> bool:
    """Predicate over FP8 dtypes (reference: utils/types.py:1-3)."""
    return jnp.issubdtype(dtype, jnp.floating) and jnp.dtype(dtype).itemsize == 1


def is_8bit_dtype(dtype) -> bool:
    """Predicate over any 8-bit dtype (reference: utils/types.py:5-6)."""
    return jnp.dtype(dtype).itemsize == 1


def resolve_interpret(interpret) -> bool:
    """Resolve the config.interpret setting to a concrete bool.

    "auto" => interpret on ``cpu`` (so correctness tests run without a
    card) and compile on ``gpu``.  Any other platform has no Pallas route
    here and raises instead of silently picking one.
    """
    if interpret != "auto":
        return bool(interpret)
    backend = default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas route for platform {backend!r}: kernels compile on "
        "'gpu' and run in interpret mode on 'cpu'"
    )
