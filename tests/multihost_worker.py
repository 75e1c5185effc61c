"""Worker for the REAL 2-process multi-host test (tests/test_parallel.py).

Each process: force the CPU platform in-process, claim 2 virtual local
devices,
join the jax.distributed coordination service through
``parallel/multihost.initialize_distributed``, build the DCN-layout pod
mesh, and run ring attention ACROSS THE PROCESS BOUNDARY (the sp axis
spans both processes' devices).  Verifies against a locally computed
fp32 SDPA oracle on this process's addressable output shards.

Invoked: python multihost_worker.py <process_id> <coordinator_port>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Both knobs must land before the backend initializes: the platform switch
# (in-process config, not env) and the virtual device count.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from quantumattention_tpu.parallel import multihost  # noqa: E402
from quantumattention_tpu.parallel.ring import ring_attention  # noqa: E402
from quantumattention_tpu.ops.sdpa import sdpa_reference  # noqa: E402


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    multihost.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.local_devices()) == 2
    assert jax.device_count() == 4

    # DCN-layout mesh: sp spans all 4 devices => ring neighbors include a
    # cross-process hop (the DCN analogue this test exists to exercise).
    mesh = multihost.pod_mesh(dp=1, sp=4, tp=1)

    B, H, S, D = 1, 2, 256, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = np.asarray(jax.random.normal(k1, (B, H, S, D), jnp.float32))
    k = np.asarray(jax.random.normal(k2, (B, H, S, D), jnp.float32))
    v = np.asarray(jax.random.normal(k3, (B, H, S, D), jnp.float32))

    sh = NamedSharding(mesh, P(None, None, "sp", None))

    def dist(x):
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: x[idx]
        )

    qd, kd, vd = dist(q), dist(k), dist(v)
    out = jax.jit(
        lambda a, b, c: ring_attention(
            a, b, c, mesh=mesh, is_causal=True, block_q=64, block_kv=64
        )
    )(qd, kd, vd)

    ref = np.asarray(
        sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       is_causal=True),
        np.float32,
    )
    # Compare this process's addressable output shards to the oracle.
    checked = 0
    for shard in out.addressable_shards:
        got = np.asarray(shard.data, np.float32)
        want = ref[shard.index]
        err = float(np.sqrt(np.mean((got - want) ** 2)))
        assert err < 1e-2, (pid, shard.index, err)
        checked += 1
    assert checked == 2, checked
    print(f"worker {pid}: ring attention across processes OK "
          f"({checked} shards checked)", flush=True)


if __name__ == "__main__":
    main()
