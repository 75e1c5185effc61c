"""Multi-chip tests on the virtual 8-device CPU mesh.

The reference has zero distributed code to mirror (SURVEY.md §2.3); these
tests validate the scale-out layer differentially against the
single-device oracle: ring sequence-parallel attention and head-sharded TP
must produce the same numbers as the unsharded fused kernel / SDPA oracle.
"""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.ops.quant import quantize_head_wise
from quantumattention_tpu.ops.sdpa import sdpa_reference
from quantumattention_tpu.parallel import mesh as qmesh
from quantumattention_tpu.parallel.ring import ring_attention
from quantumattention_tpu.parallel.tp import head_parallel_attention

RMSE_TOL = 1e-2


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def make_qkv(batch, hq, hkv, s, d, seed=0, dtype=jnp.bfloat16):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (batch, hq, s, d), jnp.float32)
    k = jax.random.normal(k2, (batch, hkv, s, d), jnp.float32)
    v = jax.random.normal(k3, (batch, hkv, s, d), jnp.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


@pytest.fixture(scope="module")
def sp_mesh():
    return qmesh.make_mesh((4,), ("sp",))


@pytest.fixture(scope="module")
def tp_mesh():
    return qmesh.make_mesh((4,), ("tp",))


@pytest.mark.parametrize("is_causal", [False, True])
def test_ring_attention_vs_oracle(sp_mesh, is_causal):
    q, k, v = make_qkv(1, 4, 4, 512, 64)
    out = ring_attention(
        q, k, v, mesh=sp_mesh, is_causal=is_causal, block_q=128, block_kv=128
    )
    ref = sdpa_reference(q, k, v, is_causal=is_causal)
    assert out.shape == q.shape
    assert rmse(out, ref) < RMSE_TOL


def test_ring_attention_gqa_window(sp_mesh):
    q, k, v = make_qkv(1, 8, 2, 512, 64)
    out = ring_attention(
        q,
        k,
        v,
        mesh=sp_mesh,
        is_causal=True,
        window=(192, 0),
        block_q=128,
        block_kv=128,
    )
    ref = sdpa_reference(q, k, v, is_causal=True, window=(192, None))
    assert rmse(out, ref) < RMSE_TOL


def test_ring_attention_jit_sharded(sp_mesh):
    """ring_attention under jit with actually-sharded inputs."""
    q, k, v = make_qkv(1, 4, 4, 512, 64)
    spec = jax.sharding.NamedSharding(
        sp_mesh, jax.sharding.PartitionSpec(None, None, "sp", None)
    )
    qs, ks, vs = (jax.device_put(t, spec) for t in (q, k, v))
    fn = jax.jit(
        lambda q, k, v: ring_attention(
            q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128
        )
    )
    out = fn(qs, ks, vs)
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_head_parallel_vs_oracle(tp_mesh):
    q, k, v = make_qkv(2, 8, 4, 256, 64)
    out = head_parallel_attention(
        q, k, v, mesh=tp_mesh, is_causal=True, block_q=128, block_kv=128
    )
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_head_parallel_fp8_scales(tp_mesh):
    q, k, v = make_qkv(1, 8, 8, 256, 64, dtype=jnp.float32)
    q8, sq = quantize_head_wise(q)
    k8, sk = quantize_head_wise(k)
    out = head_parallel_attention(
        q8,
        k8,
        v.astype(jnp.bfloat16),
        mesh=tp_mesh,
        scale_q=sq,
        scale_k=sk,
        block_q=128,
        block_kv=128,
    )
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk)
    assert rmse(out, ref) < RMSE_TOL


def test_head_parallel_rejects_indivisible(tp_mesh):
    q, k, v = make_qkv(1, 8, 2, 256, 64)
    with pytest.raises(ValueError, match="divisible"):
        head_parallel_attention(q, k, v, mesh=tp_mesh)


def test_ulysses_attention_vs_oracle(sp_mesh):
    from quantumattention_tpu.parallel.ulysses import ulysses_attention

    q, k, v = make_qkv(1, 8, 4, 512, 64)
    out = ulysses_attention(
        q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128
    )
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert out.shape == q.shape
    assert rmse(out, ref) < RMSE_TOL


def test_ulysses_rejects_indivisible_heads(sp_mesh):
    from quantumattention_tpu.parallel.ulysses import ulysses_attention

    q, k, v = make_qkv(1, 6, 2, 256, 64)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, k, v, mesh=sp_mesh)


def test_ring_matches_ulysses(sp_mesh):
    """Both SP strategies must agree with each other bit-for-bit-ish."""
    q, k, v = make_qkv(1, 4, 4, 512, 64, seed=11)
    from quantumattention_tpu.parallel.ulysses import ulysses_attention

    r = ring_attention(
        q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128
    )
    u = ulysses_attention(
        q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128
    )
    assert rmse(r, u) < 2e-3


def test_ring_attention_fp8_scales(sp_mesh):
    """Quantized ring: int8 KV payload rotates, head-wise scales replicate."""
    q, k, v = make_qkv(1, 4, 4, 512, 64, seed=13, dtype=jnp.float32)
    q8, sq = quantize_head_wise(q, jnp.int8)
    k8, sk = quantize_head_wise(k, jnp.int8)
    out = ring_attention(
        q8, k8, v.astype(jnp.bfloat16), mesh=sp_mesh,
        scale_q=sq, scale_k=sk, is_causal=True,
        block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_ring_token_wise_scales(sp_mesh):
    """Token-wise quantized ring: the per-position K scales shard over the
    sequence axis and rotate with their KV payload."""
    from quantumattention_tpu.ops.quant import quantize_token_wise

    q, k, v = make_qkv(1, 4, 4, 512, 64, seed=17, dtype=jnp.float32)
    q8, sq = quantize_token_wise(q, jnp.int8)
    k8, sk = quantize_token_wise(k, jnp.int8)
    out = ring_attention(
        q8, k8, v.astype(jnp.bfloat16), mesh=sp_mesh,
        scale_q=sq, scale_k=sk, is_causal=True,
        block_q=128, block_kv=128,
    )
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_ring_rejects_bad_scale_rank(sp_mesh):
    q, k, v = make_qkv(1, 4, 4, 512, 64, dtype=jnp.float32)
    with pytest.raises(ValueError, match="rank"):
        ring_attention(
            q, k, v, mesh=sp_mesh,
            scale_q=jnp.ones((1, 4, 512, 1)), scale_k=jnp.ones((1, 4, 512, 1)),
        )


def test_ring_causal_sp8():
    """Causal ring at sp=8 (whole virtual mesh): above-diagonal shards skip
    their kernel launch entirely; result still matches the oracle."""
    mesh = qmesh.make_mesh((8,), ("sp",))
    q, k, v = make_qkv(1, 2, 2, 1024, 64, seed=23)
    out = ring_attention(
        q, k, v, mesh=mesh, is_causal=True, block_q=128, block_kv=128
    )
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_ring_attention_natural_exp_domain(sp_mesh):
    """Ring merge must track the kernel's softmax domain config."""
    from quantumattention_tpu import config

    q, k, v = make_qkv(1, 2, 2, 512, 64, seed=21)
    with config.patch({"kernel.use_exp2": False}):
        out = ring_attention(
            q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128
        )
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_pod_mesh_and_local_batch():
    from quantumattention_tpu.parallel.multihost import (
        initialize_distributed,
        local_batch_size,
        pod_mesh,
    )

    initialize_distributed()  # single-process: must be a no-op
    m = pod_mesh(dp=2, sp=2)  # tp absorbs the rest (8 devices -> tp=2)
    assert dict(zip(m.axis_names, m.devices.shape)) == {
        "dp": 2, "sp": 2, "tp": 2,
    }
    assert local_batch_size(16, m, "dp") == 8
    with pytest.raises(ValueError, match="divisible"):
        local_batch_size(7, m, "dp")
    with pytest.raises(ValueError, match="divisible"):
        pod_mesh(dp=3)


def test_ring_attention_multiple_blocks_per_shard(sp_mesh):
    """Shards larger than one kernel block exercise q_offset arithmetic
    across block boundaries."""
    q, k, v = make_qkv(1, 2, 2, 1024, 64, seed=31)  # 256/shard, 2 blocks
    out = ring_attention(
        q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128
    )
    ref = sdpa_reference(q, k, v, is_causal=True)
    assert rmse(out, ref) < RMSE_TOL


def test_pipeline_parallel_matches_sequential():
    """GPipe-style PP over a 4-stage mesh axis must equal sequential stage
    application on every microbatch."""
    from quantumattention_tpu.parallel.pp import pipeline_apply

    mesh = qmesh.make_mesh((4,), ("pp",))
    n_stages, n_micro, mb, dim = 4, 6, 2, 64
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    params = {
        "w": jax.random.normal(keys[0], (n_stages, dim, dim), jnp.float32)
        * 0.1,
        "b": jax.random.normal(keys[1], (n_stages, dim), jnp.float32) * 0.1,
    }
    x = jax.random.normal(keys[2], (n_micro, mb, dim), jnp.float32)

    def stage_fn(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, params, x, mesh=mesh)

    ref = x
    for s in range(n_stages):
        p = {"w": params["w"][s], "b": params["b"][s]}
        ref = stage_fn(p, ref)
    assert out.shape == x.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_pipeline_parallel_attention_stage():
    """PP with a real attention block as the stage function (the fused
    kernel inside a pipeline stage)."""
    from quantumattention_tpu.parallel.pp import pipeline_apply
    import quantumattention_tpu as qa

    mesh = qmesh.make_mesh((2,), ("pp",))
    n_stages, n_micro, heads, s, d = 2, 3, 2, 128, 64
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    params = {
        "wo": jax.random.normal(keys[0], (n_stages, heads * d, heads * d),
                                jnp.float32) * 0.05,
    }
    x = jax.random.normal(keys[1], (n_micro, 1, s, heads * d), jnp.float32)

    def stage_fn(p, a):
        b = a.shape[0]
        qkv = a.reshape(b, s, heads, d).transpose(0, 2, 1, 3)
        qkv = qkv.astype(jnp.bfloat16)
        att = qa.attn_func(qkv, qkv, qkv, is_causal=True)
        att = att.transpose(0, 2, 1, 3).reshape(b, s, heads * d)
        return a + att.astype(jnp.float32) @ p["wo"]

    out = pipeline_apply(stage_fn, params, x, mesh=mesh)
    ref = x
    for st in range(n_stages):
        ref = stage_fn({"wo": params["wo"][st]}, ref.reshape(-1, s, heads * d)).reshape(x.shape)
    assert rmse(out, ref) < 1e-2


def test_multihost_two_process_ring():
    """REAL multi-process jax.distributed run (VERDICT r3 item 7): two
    subprocesses join a coordination service via
    multihost.initialize_distributed, build the DCN-layout pod mesh
    (sp axis spanning both processes), and run ring attention across the
    process boundary — the first time parallel/multihost.py's distributed
    path actually executes distributed (tests/multihost_worker.py)."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:  # grab a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "ring attention across processes OK" in out, out
