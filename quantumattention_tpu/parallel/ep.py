"""Expert parallelism: GShard-style all_to_all dispatch over an "ep" axis.

The reference is single-GPU with no MoE or expert-parallel story
(SURVEY.md §2.3 marks EP "not in scope" for parity); this module closes
the completeness gap with the GShard formulation (§3.2):

  * tokens are sharded over the ``ep`` mesh axis (batch dim), experts are
    sharded over the same axis (leading E dim of the stacked weights);
  * each shard routes its local tokens against ALL experts and builds the
    dense (E, C_local, H) dispatch batch (``models/moe.py``);
  * ONE ``jax.lax.all_to_all`` swaps the expert axis for the capacity
    axis — after it, every device holds *its* experts' token groups from
    *all* shards (E/ep, C_local·ep, H); the expert SwiGLU runs on the
    local weight shard; a mirrored all_to_all sends results home;
  * XLA compiles the pair of all_to_alls onto ICI and overlaps them with
    the expert matmuls (latency-hiding scheduler) — no hand-rolled
    send/recv, matching how ring/tp/pp in this package are built.

Semantics note: capacity is per *shard* (C_local = capacity(N/ep)), so
token dropping is decided shard-locally.  With a capacity factor high
enough that nothing drops, the sharded result equals the single-device
``moe_ffn`` exactly (the parity test in tests/test_moe.py asserts this);
under pressure the drop *sets* may differ — same contract as GShard.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models import moe as moe_lib

Params = Dict[str, Any]


def moe_param_specs(axis_name: str = "ep") -> Params:
    """PartitionSpecs for ``models/moe.init_moe_params`` under EP: the
    router is replicated (every shard routes against all experts), the
    stacked expert weights shard on their leading E axis."""
    return {
        "w_router": P(),
        "w_gate": P(axis_name),
        "w_up": P(axis_name),
        "w_down": P(axis_name),
    }


def expert_parallel_ffn(
    moe: Params,
    x: jax.Array,
    *,
    mesh: Mesh,
    axis_name: str = "ep",
    num_experts_per_tok: int = 2,
    capacity_factor: float = 2.0,
) -> jax.Array:
    """Sparse MoE FFN with experts sharded over ``axis_name``.

    Args:
      moe: ``init_moe_params`` pytree (global shapes; sharded per
        ``moe_param_specs``).
      x: (B, S, H) activations, batch-sharded over ``axis_name``.

    Returns (B, S, H), batch-sharded like ``x``.
    """
    n_shards = mesh.shape[axis_name]
    num_experts = moe["w_router"].shape[-1]
    if num_experts % n_shards != 0:
        raise ValueError(
            f"num_experts ({num_experts}) must be divisible by the ep axis "
            f"size ({n_shards})"
        )
    if x.shape[0] % n_shards != 0:
        raise ValueError(
            f"batch ({x.shape[0]}) must be divisible by the ep axis size "
            f"({n_shards})"
        )

    def ep_expert_fn(moe_local, x_e):
        # x_e: (E, C_local, H) — local tokens dispatched to all experts.
        # Swap E <-> C: each device keeps E/ep experts, gains ep-fold
        # capacity rows (one group per source shard).
        xs = jax.lax.all_to_all(
            x_e, axis_name, split_axis=0, concat_axis=1, tiled=True
        )
        ys = moe_lib.expert_ffn(moe_local, xs)  # local weight shard
        return jax.lax.all_to_all(
            ys, axis_name, split_axis=1, concat_axis=0, tiled=True
        )

    def local(moe_local, xl):
        return moe_lib.moe_ffn(
            moe_local,
            xl,
            num_experts_per_tok=num_experts_per_tok,
            capacity_factor=capacity_factor,
            expert_fn=ep_expert_fn,
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(moe_param_specs(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )(moe, x)
