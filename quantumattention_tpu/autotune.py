"""Shared-memory fit model, timed choice sweeps and their on-disk cache.

The reference delegates autotuning to Inductor's
``autotune_select_algorithm`` (reference: inductor/kernels/attention.py:1034),
benchmarking a pruned choice list per call site and caching the winner.
This module supplies the same contract for the Hopper kernels:

  * a **fit model** of one block's shared memory (232,448 bytes on Hopper)
    that decides how deep a kernel's K/V pipeline can be, and rejects a tile
    that cannot run at all before anything is compiled (analogue of
    ``early_attention_config_prune``, reference attention.py:765-785);
  * a **timed sweep** on the host clock around ``block_until_ready``, run
    once per shape class (``dispatch``'s ``scaling_method="auto"`` path
    choice);
  * a **persistent JSON cache** keyed by (device kind, shape class) — the
    analogue of Inductor's best-config cache.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

_CACHE: Optional[Dict[str, Any]] = None

#: Shared memory one thread block may use on Hopper (227 KB of the SM's
#: 256 KB; the hardware limit Mosaic GPU and Triton compile against).
SMEM_BYTES = 232_448

#: Shared memory the compiler keeps for barriers, reductions and layout
#: conversions beside the operand tiles.
SMEM_RESERVE = 16 * 1024


def smem_bytes(
    block_q: int,
    block_kv: int,
    head_dim: int,
    q_bytes: int,
    kv_bytes: int,
    num_stages: int,
) -> int:
    """Operand bytes of one attention program: the resident Q tile plus
    ``num_stages`` buffered K and V tiles."""
    return (
        block_q * head_dim * q_bytes
        + num_stages * 2 * block_kv * head_dim * kv_bytes
    )


def smem_fits(
    block_q: int,
    block_kv: int,
    head_dim: int,
    q_bytes: int,
    kv_bytes: int,
    num_stages: int,
) -> bool:
    """Whether the tiles fit one block's shared memory on Hopper."""
    need = smem_bytes(block_q, block_kv, head_dim, q_bytes, kv_bytes, num_stages)
    return need + SMEM_RESERVE <= SMEM_BYTES


def cache_path() -> Path:
    root = os.environ.get(
        "QUANTUM_ATTN_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "quantumattention_tpu"),
    )
    return Path(root) / "autotune.json"


def _pretuned_path() -> Path:
    return Path(__file__).parent / "pretuned.json"


def _load_cache() -> Dict[str, Any]:
    """User cache merged over the packaged pretuned defaults.

    ``pretuned.json`` ships winners measured on real hardware (keys carry
    the device kind, so foreign entries are inert); the user's on-disk
    cache always wins.
    """
    global _CACHE
    if _CACHE is None:
        try:
            base = json.loads(_pretuned_path().read_text())
        except (OSError, ValueError):
            base = {}
        try:
            base.update(json.loads(cache_path().read_text()))
        except (OSError, ValueError):
            pass
        _CACHE = base
    return _CACHE


def _save_cache() -> None:
    if _CACHE is None:
        return
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(_CACHE, indent=1, sort_keys=True))
    except OSError:  # pragma: no cover - cache is best-effort
        pass


def _bucket(n: int) -> int:
    """Sequence-length bucket: exact up to 1k, then powers of two."""
    if n <= 1024:
        return n
    b = 1024
    while b < n:
        b *= 2
    return b


def shape_key(
    kind: str,
    batch: int,
    heads: int,
    kv_heads: int,
    q_len: int,
    kv_len: int,
    head_dim: int,
    causal: bool,
    dtype,
) -> str:
    dev = jax.devices()[0].device_kind.replace(" ", "_")
    return (
        f"{dev}|{kind}|b{batch}h{heads}kv{kv_heads}"
        f"|sq{_bucket(q_len)}skv{_bucket(kv_len)}d{head_dim}"
        f"|c{int(causal)}|{jnp.dtype(dtype).name}"
    )


def time_call(fn: Callable[..., Any], args: tuple = (), reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` on the host clock around
    ``block_until_ready``, after one warm-up call that compiles."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def run_outside_trace(fn: Callable[[], object]):
    """Run ``fn()`` on a fresh thread, escaping any ambient JAX trace (JAX
    trace state is thread-local).

    This is how in-jit tuning executes real compiled kernels at trace
    time.  ``jax.ensure_compile_time_eval()`` is NOT usable for this: under
    it ``pallas_call`` kernels are traced against eval rules that don't
    exist (``program_id``).  A clean thread sees no ambient trace, so jit
    and pallas compile and execute normally on the same devices.
    """
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        return ex.submit(fn).result()


def lookup(key: str):
    """Cached winner for ``key`` (lists come back as tuples), or None."""
    hit = _load_cache().get(key)
    return tuple(hit) if isinstance(hit, list) else hit


def record(key: str, value) -> None:
    _load_cache()[key] = list(value) if isinstance(value, tuple) else value
    _save_cache()


def synth_like(t: "jax.Array") -> "jax.Array":
    """A concrete random array matching a (possibly abstract) array's shape
    class.

    The enabler for tuning *inside* ``jax.jit``: JAX tracing only carries
    avals, so we synthesize device-resident inputs of the same shape/dtype
    and time those.
    """
    dtype = jnp.dtype(t.dtype)
    key = jax.random.PRNGKey(0)
    if jnp.issubdtype(dtype, jnp.integer):
        iinfo = jnp.iinfo(dtype)
        return jax.random.randint(
            key, t.shape, iinfo.min // 2, iinfo.max // 2, jnp.int32
        ).astype(dtype)
    if dtype.itemsize == 1:  # fp8: sample in a safe range then cast
        return (jax.random.normal(key, t.shape, jnp.float32) * 10).astype(dtype)
    return jax.random.normal(key, t.shape, dtype)


def tune(key: str, runner_for: Callable[[Any], Any], choices: Sequence[Any]):
    """Time each choice once, cache and return the winner.

    ``runner_for(choice)`` returns either a zero-argument callable or an
    ``(fn, args)`` pair whose buffers ride as call arguments.  A choice
    that fails to run raises: choices that cannot run on the card are
    pruned by the caller (the fit model above) before they are timed.
    """
    hit = lookup(key)
    if hit is not None:
        return hit
    best, best_t = None, float("inf")
    for choice in choices:
        run = runner_for(choice)
        fn, args = run if isinstance(run, tuple) else (run, ())
        t = time_call(fn, tuple(args))
        if t < best_t:
            best, best_t = choice, t
    record(key, best)
    return lookup(key)
