"""Parameter checkpoint save/load (SURVEY.md §5 checkpoint/resume).

The reference has no persistence (inference-only kernels); this build's
model layer needs it for serving and training restarts.  Format: one .npz
holding every leaf keyed by its pytree path — dependency-free, portable,
and mmap-friendly on load.  (For multi-host sharded checkpoints, orbax is
the production choice; this covers the single-host engine/training flows.)
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Union

import jax
import numpy as np


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:  # pragma: no cover - future jax path types
            parts.append(str(p))
    return "/".join(parts)


def _normalize(path: Union[str, Path]) -> Path:
    """np.savez appends '.npz' to extensionless paths; mirror that on load
    so a save/load round-trip with one path string works."""
    path = Path(path)
    if path.suffix != ".npz":
        path = Path(str(path) + ".npz")
    return path


def save_params(params: Any, path: Union[str, Path]) -> None:
    """Write a params pytree to ``path`` (.npz)."""
    path = _normalize(path)
    leaves = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for kpath, leaf in flat:
        arr = np.asarray(leaf)
        if arr.dtype not in (
            np.float32, np.float64, np.int32, np.int64, np.int8,
            np.uint8, np.bool_, np.float16,
        ):
            # npz cannot serialize ml_dtypes (bfloat16, fp8); store as
            # float32 (lossless upcast) — load casts back to the template
            # dtype.
            arr = arr.astype(np.float32)
        leaves[_path_str(kpath)] = arr
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **leaves)


def load_params(template: Any, path: Union[str, Path]) -> Any:
    """Load a checkpoint into the structure (and dtypes) of ``template``.

    ``template`` supplies the pytree structure — typically
    ``init_params(key, cfg)`` output (its values are discarded).
    """
    with np.load(_normalize(path)) as data:
        flat, treedef = jax.tree_util.tree_flatten_with_path(template)
        loaded = []
        for kpath, leaf in flat:
            key = _path_str(kpath)
            if key not in data:
                raise KeyError(f"checkpoint missing parameter {key!r}")
            arr = data[key]
            if arr.shape != leaf.shape:
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint {arr.shape} "
                    f"vs template {leaf.shape}"
                )
            loaded.append(jax.numpy.asarray(arr, dtype=leaf.dtype))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), loaded
    )
