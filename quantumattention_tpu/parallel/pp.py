"""Pipeline parallelism: GPipe-style microbatch streaming over a mesh axis.

The reference is single-GPU and has no pipeline story (SURVEY.md §2.3 marks
PP "not in scope" for parity); this module closes the gap with a minimal but
real implementation: stages are laid out along a ``pp`` mesh axis,
activations flow stage-to-stage with ``jax.lax.ppermute``,
and microbatches stream through the classic fill/steady/drain schedule
(n_micro + n_stages - 1 ticks).

Design notes:
  * stage parameters are a STACKED pytree — every leaf carries a leading
    ``n_stages`` axis and is sharded ``P("pp")`` so each device holds
    exactly its stage's slice (homogeneous stages, e.g. transformer
    blocks);
  * the whole schedule is one ``lax.scan`` inside ``shard_map`` — XLA sees
    a static loop of compute + ppermute pairs and overlaps the transfer
    of tick t with the compute of tick t+1 (latency-hiding scheduler)
    instead of hand-rolled send/recv queues;
  * bubbles are the standard GPipe fill/drain ticks: utilization is
    n_micro / (n_micro + n_stages - 1) — callers pick the microbatch count
    accordingly.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def pipeline_apply(
    stage_fn: Callable[[Any, jax.Array], jax.Array],
    stacked_params: Any,
    x: jax.Array,
    *,
    mesh: Mesh,
    axis_name: str = "pp",
) -> jax.Array:
    """Run ``n_stages`` chained applications of ``stage_fn`` as a pipeline.

    Args:
      stage_fn: ``(params_slice, activation) -> activation`` for ONE stage;
        must preserve the activation shape/dtype (transformer-block style).
      stacked_params: pytree whose every leaf has a leading axis of size
        ``n_stages`` (stage i uses ``leaf[i]``); sharded over ``axis_name``.
      x: microbatched input ``(n_micro, microbatch, ...)``, replicated.

    Returns:
      ``(n_micro, microbatch, ...)`` outputs, equal to applying the stages
      sequentially to every microbatch; replicated across the axis.
    """
    n_stages = mesh.shape[axis_name]

    def body(params, x):
        # Local stage slice: shard_map hands each device a leading axis of
        # size 1.
        p = jax.tree.map(lambda a: a[0], params)
        rank = jax.lax.axis_index(axis_name)
        n = jax.lax.axis_size(axis_name)
        n_micro = x.shape[0]
        n_ticks = n_micro + n - 1
        # Forward shift (no wraparound): stage r's output goes to r+1; the
        # last stage's send is dropped, stage 0 receives zeros.
        perm = [(i, i + 1) for i in range(n - 1)]

        def tick(carry, t):
            act, outbuf = carry
            # Stage 0 injects microbatch t (garbage after the fill phase —
            # masked out of the output buffer below); later stages process
            # what arrived over ICI last tick.
            inject = x[jnp.clip(t, 0, n_micro - 1)]
            cur = jnp.where(rank == 0, inject, act)
            y = stage_fn(p, cur)
            # The last stage completes microbatch t - (n-1) at tick t.
            mi = t - (n - 1)
            ok = jnp.logical_and(rank == n - 1, mi >= 0)
            outbuf = jax.lax.cond(
                ok,
                lambda ob: jax.lax.dynamic_update_index_in_dim(
                    ob, y, jnp.maximum(mi, 0), 0
                ),
                lambda ob: ob,
                outbuf,
            )
            act_next = jax.lax.ppermute(y, axis_name, perm)
            return (act_next, outbuf), None

        act0 = jnp.zeros_like(x[0])
        out0 = jnp.zeros_like(x)
        (_, outbuf), _ = jax.lax.scan(
            tick, (act0, out0), jnp.arange(n_ticks)
        )
        # Replicate the result off the last stage.
        return jax.lax.psum(
            jnp.where(rank == n - 1, outbuf, jnp.zeros_like(outbuf)),
            axis_name,
        )

    param_specs = jax.tree.map(lambda _: P(axis_name), stacked_params)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(param_specs, P()),
        out_specs=P(),
        check_vma=False,
    )(stacked_params, x)
