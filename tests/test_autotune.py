"""Autotuner unit tests (fit model, cache, sweep logic — no card needed)."""

import json

import jax.numpy as jnp
import pytest

from quantumattention_tpu import autotune


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QUANTUM_ATTN_CACHE_DIR", str(tmp_path))
    autotune._CACHE = None
    yield
    autotune._CACHE = None


def test_shape_key_buckets_long_sequences():
    k1 = autotune.shape_key("flash", 1, 8, 8, 5000, 5000, 128, True, jnp.bfloat16)
    k2 = autotune.shape_key("flash", 1, 8, 8, 6000, 6000, 128, True, jnp.bfloat16)
    k3 = autotune.shape_key("flash", 1, 8, 8, 9000, 9000, 128, True, jnp.bfloat16)
    assert k1 == k2  # both bucket to 8192
    assert k1 != k3  # 16384 bucket


@pytest.mark.parametrize(
    "block_q,block_kv,head_dim,q_bytes,kv_bytes,stages,fits",
    [
        # The per-head-dim defaults fit with a pipelined K/V ring.
        (128, 128, 64, 2, 2, 3, True),
        (128, 128, 128, 2, 2, 2, True),
        (128, 64, 256, 2, 2, 2, True),
        # 8-bit K/V tiles halve the ring: a third stage fits at D = 128.
        (128, 128, 128, 2, 1, 3, True),
        # ...but not in bf16, and D = 256 needs the 64-row KV tile.
        (128, 128, 128, 2, 2, 3, False),
        (128, 128, 256, 2, 2, 2, False),
        (128, 128, 256, 2, 2, 1, True),
        # fp32 operands at large tiles exceed one block's shared memory.
        (256, 256, 128, 4, 4, 1, False),
    ],
)
def test_prune_respects_vmem(block_q, block_kv, head_dim, q_bytes, kv_bytes,
                             stages, fits):
    """The Hopper shared-memory fit model (232,448 bytes a block)."""
    need = autotune.smem_bytes(block_q, block_kv, head_dim, q_bytes, kv_bytes,
                               stages)
    assert need == (block_q * head_dim * q_bytes
                    + stages * 2 * block_kv * head_dim * kv_bytes)
    assert autotune.smem_fits(
        block_q, block_kv, head_dim, q_bytes, kv_bytes, stages
    ) is fits


def test_prune_shrinks_for_short_seqs():
    """choose_tiles keeps the deepest pipeline the fit model admits and
    rejects tiles that cannot run at all; the kernel shrinks tiles to
    short sequences."""
    from quantumattention_tpu.ops import flash

    t = flash.choose_tiles(128, 2, 2)
    assert (t.block_q, t.block_kv) == flash.default_tiles(128)[:2]
    assert autotune.smem_fits(t.block_q, t.block_kv, 128, 2, 2, t.num_stages)
    assert not autotune.smem_fits(
        t.block_q, t.block_kv, 128, 2, 2, t.num_stages + 1
    )
    assert flash.choose_tiles(256, 2, 2, 128, 128).num_stages == 1
    with pytest.raises(ValueError, match="shared memory"):
        flash.choose_tiles(256, 4, 4, 256, 256)
    with pytest.raises(ValueError, match="powers of two"):
        flash.choose_tiles(128, 2, 2, 96, 128)
    q = jnp.ones((1, 1, 40, 64), jnp.bfloat16)
    out = flash.flash_attention(q, q, q)  # 64-row tiles cover S = 40
    assert out.shape == q.shape


def test_tune_caches_winner(tmp_path):
    calls = []

    def runner(choice):
        def run():
            calls.append(choice)
            import time

            time.sleep(0.01 if choice == (128, 128) else 0.05)
            return jnp.zeros((2, 2))

        return run

    key = "test|key"
    best = autotune.tune(key, runner, [(128, 128), (256, 256)])
    assert best == (128, 128)
    # Cached on disk.
    data = json.loads(autotune.cache_path().read_text())
    assert data[key] == [128, 128]
    # Second call short-circuits (no new timing runs).
    n = len(calls)
    best2 = autotune.tune(key, runner, [(128, 128), (256, 256)])
    assert best2 == (128, 128)
    assert len(calls) == n


def test_tune_skips_failing_candidates():
    """A failing choice is not skipped: the error propagates and nothing
    is cached (choices that cannot run are pruned before timing)."""
    def runner(choice):
        def run():
            if choice == (128, 128):
                raise RuntimeError("compile OOM")
            return jnp.zeros((2, 2))

        return run

    with pytest.raises(RuntimeError, match="compile OOM"):
        autotune.tune("test|fail", runner, [(128, 128), (256, 256)])
    assert autotune.lookup("test|fail") is None


def test_tune_chained_runner_times_and_caches():
    """String choices (the dispatcher's path names) time and cache like
    tile pairs."""
    def runner(choice):
        n = 128 if choice == "small" else 256

        def run(x):
            return (x[:n] * 2.0).sum(axis=1, keepdims=True)

        return run, (jnp.ones((256, 128), jnp.float32),)

    best = autotune.tune("test|chained", runner, ["small", "large"])
    assert best in ("small", "large")
    data = json.loads(autotune.cache_path().read_text())
    assert data["test|chained"] == best


def test_time_chained_matches_contract():
    """time_call: one warm-up call, then ``reps`` timed calls that each
    wait for the device (block_until_ready)."""
    calls = []

    def run(x):
        calls.append(1)
        return x + 1.0

    t = autotune.time_call(run, (jnp.zeros((4, 4)),), reps=3)
    assert t >= 0.0
    assert len(calls) == 4


def test_run_outside_trace_escapes_ambient_trace():
    """run_outside_trace must execute jitted work eagerly even while an
    outer trace is active (the in-jit pre-tune path; a fresh thread sees
    no ambient trace — ensure_compile_time_eval cannot compile pallas)."""
    import jax
    import jax.numpy as jnp

    results = {}

    def f(x):
        def sweep():
            y = jax.jit(lambda a: a * 2.0)(jnp.ones((4,), jnp.float32))
            return float(y.sum())

        results["val"] = autotune.run_outside_trace(sweep)
        return x + 1

    jax.jit(f)(jnp.zeros((2,), jnp.float32))
    assert results["val"] == 8.0


def test_pretuned_defaults_merge(tmp_path, monkeypatch):
    """Packaged pretuned.json supplies defaults; the user cache wins."""
    import json as _json

    fake = tmp_path / "pretuned.json"
    fake.write_text(_json.dumps({"dev|flash|shipped": [512, 1024],
                                 "dev|flash|both": [256, 256]}))
    monkeypatch.setattr(autotune, "_pretuned_path", lambda: fake)
    autotune._CACHE = None
    assert autotune.lookup("dev|flash|shipped") == (512, 1024)
    # user record overrides the shipped value and persists
    autotune.record("dev|flash|both", (1024, 2048))
    autotune._CACHE = None
    assert autotune.lookup("dev|flash|both") == (1024, 2048)
    assert autotune.lookup("dev|flash|shipped") == (512, 1024)


def test_tune_accepts_runner_pairs():
    """(fn, args) runner pairs: buffers ride as call arguments."""
    big = jnp.ones((64, 128), jnp.float32)

    def runner(choice):
        bq = choice[0]

        def run(x):
            return (x[:bq // 64 + 1] * 2.0).sum(axis=1, keepdims=True)

        return run, (big,)

    best = autotune.tune("test|pair", runner, [(128, 128), (256, 256)])
    assert best in [(128, 128), (256, 256)]
    data = json.loads(autotune.cache_path().read_text())
    assert data["test|pair"] == list(best)
