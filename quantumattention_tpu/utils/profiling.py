"""Profiling / timing utilities (SURVEY.md §5 tracing subsystem).

The reference's profiling story is nvcc ``-lineinfo`` plus
``triton.testing.do_bench`` inside tests; here it is ``jax.profiler``
traces and host-clock timing around ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``jax.profiler`` trace of the enclosed block into
    ``log_dir`` (read it with ``jax.profiler.ProfileData.from_file`` or a
    trace viewer)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def bench(fn: Callable[..., jax.Array], args=(), iters: int = 10) -> float:
    """Median seconds per call of ``jax.jit(fn)(*args)``: host clock around
    ``block_until_ready``, after one warm-up call that compiles."""
    from ..autotune import time_call

    return time_call(jax.jit(fn), tuple(args), reps=iters)


def attention_tflops(
    seconds: float,
    batch: int,
    heads: int,
    q_len: int,
    kv_len: int,
    head_dim: int,
    causal: bool = False,
) -> float:
    """Reference FLOP model (tests/test_interface.py:121-126)."""
    flops = 2 * (2 * batch * heads * q_len * kv_len * head_dim)
    if causal:
        flops //= 2
    return flops / seconds / 1e12
