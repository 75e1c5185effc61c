"""Device-mesh sharding for the model layer.

The reference is strictly single-GPU (SURVEY.md §2.3: zero distributed code).
This module supplies the scale-out story: a named ``jax.sharding.Mesh``
plus PartitionSpecs per parameter, and XLA/GSPMD inserts the collectives
(all-gather for row-sharded matmuls, reduce-scatter / psum for col-sharded
ones), which XLA hands to NCCL.  The cards of one host are joined all to
all by NVLink, so the mesh follows the algorithm alone: no axis order is
faster than another.

Axes:
  * ``dp`` — data parallel: batch dim of activations.
  * ``tp`` — tensor parallel: attention heads + MLP intermediate dim
    (Megatron-style col/row split; GQA co-location per the scaling-book
    recipe — Q heads land on the chip that owns their KV head).
  * ``sp`` — sequence parallel: KV sequence dim, consumed by ring attention
    (parallel/ring.py) rather than by GSPMD.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.llama import LlamaConfig


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a named mesh over the available devices.

    With no ``shape``, all devices go to the last axis (pure TP on one host).
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (len(devices),)
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def llama_param_specs(cfg: LlamaConfig) -> Any:
    """PartitionSpec pytree matching ``models.llama.init_params``.

    Megatron layout on the ``tp`` axis: QKV projections column-sharded
    (heads split across chips), output projection row-sharded (partial sums
    -> psum inserted by GSPMD); same col/row split for the SwiGLU MLP.
    Embedding is vocab-sharded; norms replicated.
    """
    layer = {
        "attn_norm": P(),
        "wq": P(None, "tp"),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
        "mlp_norm": P(),
    }
    if cfg.num_experts > 0:
        # MoE under tp: every expert's SwiGLU gets the same Megatron
        # col/row split on its trailing dims (the E axis is the ep axis's
        # business — see parallel/ep.moe_param_specs).
        layer["moe"] = {
            "w_router": P(),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        }
    else:
        layer.update(
            w_gate=P(None, "tp"),
            w_up=P(None, "tp"),
            w_down=P("tp", None),
        )
    if cfg.qkv_bias:
        layer.update(bq=P("tp"), bk=P("tp"), bv=P("tp"))
    specs = {
        "embed": P("tp", None),
        "final_norm": P(),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "tp")
    return specs


def param_specs_for(params: Any, cfg: LlamaConfig) -> Any:
    """``llama_param_specs`` adapted to a params tree that may hold w8a16
    quantized leaves (``models/quantized``: ``{"q": int8, "s": fp32}``).

    The int8 codes take the full matrix's spec; the scale inherits it with
    every size-1 dim unsharded (scales are per-output-channel keepdims, so
    the sharded output axis survives and the reduced axis drops out — e.g.
    wq (in, out) P(None, "tp") -> s (1, out) P(None, "tp"); wo (out, in)
    P("tp", None) -> s (1, in) P(None, None); embed rows (V, 1) keep the
    vocab sharding)."""
    from ..models import quantized as qz

    base = llama_param_specs(cfg)

    def walk(p: Any, s: Any) -> Any:
        if qz.is_quantized(p):
            scale = p["s"]
            axes = list(s) + [None] * (scale.ndim - len(list(s)))
            sspec = P(*[
                ax if scale.shape[i] != 1 else None
                for i, ax in enumerate(axes[: scale.ndim])
            ])
            return {"q": s, "s": sspec}
        if qz.is_quantized4(p):
            # w4a16: packed codes (in/2, out) shard like the full matrix
            # (both axes survive packing/grouping, just shrunk 2x/128x),
            # and the (in/128, out) group scales take the SAME spec (the
            # input axis exists here, unlike int8's size-1 keepdim).
            return {"q4": s, "s": s}
        if isinstance(p, dict):
            if "w_qkv" in p or "w_gate_up" in p:
                raise ValueError(
                    "fused projection trees (quantized.fuse_projections) "
                    "cannot be tensor-parallel sharded: the tp column "
                    "shard of a concatenated [gate|up] puts all-gate "
                    "halves on chip 0 — fuse only for single-chip serving"
                )
            return {k: walk(v, s[k]) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(a, b) for a, b in zip(p, s)]
        return s

    return walk(params, base)


def shard_params(params: Any, mesh: Mesh, specs: Any) -> Any:
    """Place a params pytree onto the mesh per the given specs."""
    return jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs
    )


def batch_spec() -> P:
    """Activations/tokens: batch over dp, everything else replicated."""
    return P("dp", None)
