"""Multi-process bootstrap and global mesh construction.

The reference has no multi-device story; this is the multi-process entry
point: ``jax.distributed.initialize`` (the JAX-native replacement for the
NCCL/MPI world the reference never had), plus a helper that lays mesh axes
out over every device of the job.  Within one host the cards are joined
all to all by NVLink; only the slowest axis (dp) should cross hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

from .mesh import make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the JAX distributed runtime (no-op if single-process).

    Pass the arguments explicitly (``localhost:<port>`` for processes on
    one host) or via JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID (jax reads the coordinator address
    itself but not the process id, so it is read here).
    """
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if (
        num_processes is not None
        and num_processes <= 1
        and coordinator_address is None
    ):
        return  # explicit single-process: nothing to bring up
    if (
        num_processes is None
        and coordinator_address is None
        and os.environ.get("JAX_COORDINATOR_ADDRESS") is None
    ):
        return  # no distributed configuration present at all
    # None values are passed through so jax's cluster auto-detection
    # (SLURM, ...) can fill them in.
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def pod_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "sp", "tp"),
) -> Mesh:
    """Global mesh over every device in the job.

    Axis order is slowest-varying first: **dp outermost** (the only axis
    that may cross hosts — gradient/step-level collectives), then sp, then
    **tp innermost** (per-layer collectives stay within a host's NVLink
    domain).  ``tp=None`` absorbs the remaining devices.
    """
    n = jax.device_count()
    if tp is None:
        if n % (dp * sp) != 0:
            raise ValueError(
                f"device count {n} not divisible by dp*sp = {dp * sp}"
            )
        tp = n // (dp * sp)
    if dp * sp * tp != n:
        raise ValueError(
            f"dp*sp*tp = {dp * sp * tp} != device count {n}"
        )
    return make_mesh((dp, sp, tp), axis_names)


def local_batch_size(global_batch: int, mesh: Mesh, axis: str = "dp") -> int:
    n = mesh.shape[axis]
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {axis}={n}")
    return global_batch // n
