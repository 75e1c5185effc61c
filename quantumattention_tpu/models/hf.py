"""HuggingFace checkpoint import for the Llama-family decoder.

The reference ships no model layer at all (SURVEY.md §0) — but a serving/
training framework is only usable if real weights load into it, so this
module maps `transformers` Llama / Qwen2 / Mistral / Mixtral checkpoints
onto `models/llama.py`'s parameter tree.  Pure renaming + transposes: the
decoder follows the HF conventions exactly (rotate-half RoPE, blockwise
GQA head grouping, `sliding_window` = w keys including self), which the
cross-framework logit-parity test in tests/test_hf.py asserts end to end.

Weights come in as a ``state_dict`` (torch tensors or numpy arrays) plus
the HF config; nothing here imports torch or transformers — conversion to
numpy happens via duck typing, so the module works with safetensors dicts
too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from .llama import LlamaConfig, Params


def _has_qkv_bias(sd: Mapping[str, Any]) -> bool:
    """State-dict probe: does this checkpoint carry q/k/v projection
    biases?  (Qwen2 ships them with no config flag.)"""
    return any(k.endswith("self_attn.q_proj.bias") for k in sd)


def _to_np(t: Any) -> np.ndarray:
    """torch.Tensor / np.ndarray / array-like -> float32 numpy."""
    if hasattr(t, "detach"):  # torch tensor, no torch import needed
        t = t.detach()
        if hasattr(t, "float"):
            t = t.float()
        t = t.cpu().numpy()
    return np.asarray(t, np.float32)


def config_from_hf(hf_config: Any, **overrides) -> LlamaConfig:
    """Map a transformers config (Llama/Qwen2/Mistral/Mixtral) onto
    :class:`LlamaConfig`.  Accepts the config object or a plain dict."""
    get = (
        hf_config.get
        if isinstance(hf_config, Mapping)
        else lambda k, d=None: getattr(hf_config, k, d)
    )
    hidden = get("hidden_size")
    heads = get("num_attention_heads")
    cfg = LlamaConfig(
        vocab_size=get("vocab_size"),
        hidden_size=hidden,
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_q_heads=heads,
        num_kv_heads=get("num_key_value_heads", heads),
        head_dim=get("head_dim") or hidden // heads,
        rope_theta=float(get("rope_theta", 10000.0)),
        rms_norm_eps=float(get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        qkv_bias=bool(
            get("attention_bias", False) or get("qkv_bias", False)
        ),
        window=get("sliding_window", None)
        if get("use_sliding_window", True)
        else None,
        num_experts=get("num_local_experts", 0) or 0,
        num_experts_per_tok=get("num_experts_per_tok", 2) or 2,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def params_from_hf(
    state_dict: Mapping[str, Any], cfg: LlamaConfig, dtype=None,
    quantize=False,
) -> Params:
    """Convert an HF Llama-family ``state_dict`` to the native tree.

    HF linear weights are (out, in); the native tree stores (in, out), so
    every projection transposes.  Norm weights stay fp32 (the native
    rms_norm computes in fp32).

    ``quantize`` ("int8"/True, or "int4"): quantize each projection the
    moment it is converted, INSIDE a jit, so the full-precision copy is a
    transient XLA temporary — never a live device buffer.  This is what
    makes loading a real 8B-class checkpoint onto a 16 GB chip possible
    at all: the bf16 tree alone (~16 GB) exceeds HBM, so the all-then-
    quantize order of ``quantized.quantize_params`` cannot run at design
    scale.  The result is bit-identical to quantizing after the fact
    (same quantize_matrix math on the same dtype-cast values — asserted
    in tests/test_hf.py::test_hf_checkpoint_streaming_quantize).
    """
    from . import quantized as qz

    dtype = dtype or cfg.dtype
    sd = state_dict
    if quantize not in (False, True, "int8", "int4"):
        raise ValueError(
            f"quantize must be False/True/'int8'/'int4', got {quantize!r}"
        )
    qmode = {False: None, True: "int8", "int8": "int8", "int4": "int4"}[
        quantize
    ]
    _q8 = jax.jit(qz.quantize_matrix)
    _q4 = jax.jit(qz.quantize_matrix_int4)
    _qe = jax.jit(qz.quantize_embed)

    def qproj(arr):
        """Quantize one converted (in, out) projection on device."""
        if qmode == "int4" and arr.ndim == 2 and arr.shape[0] % 256 == 0:
            return _q4(arr)
        return _q8(arr)
    if not cfg.qkv_bias and _has_qkv_bias(sd):
        # Qwen2 puts biases on q/k/v unconditionally while its config
        # carries no flag for it (transformers' Qwen2Config has neither
        # attention_bias nor qkv_bias) — loading with cfg.qkv_bias=False
        # would silently DROP the bias tensors and serve garbage logits.
        # The loaders detect this from the state dict (_cfg_with_detected_
        # bias); direct params_from_hf callers must pass a matching cfg.
        raise ValueError(
            "checkpoint has q/k/v projection biases but cfg.qkv_bias is "
            "False — build the config with config_from_hf(..., "
            "qkv_bias=True) or use load_hf_model/load_hf_checkpoint"
        )

    def w(name):  # transposed projection in compute dtype
        arr = jnp.asarray(_to_np(sd[name]).T, dtype)
        return qproj(arr) if qmode else arr

    def w8(name):
        # lm_head / MoE expert matrices stay int8 even under int4 (mirrors
        # quantized.quantize_params_int4).
        arr = jnp.asarray(_to_np(sd[name]).T, dtype)
        return _q8(arr) if qmode else arr

    def direct(name, dt):
        return jnp.asarray(_to_np(sd[name]), dt)

    def key(name):
        # lm_head lives at top level; everything else under "model."
        return name if name in sd else "model." + name

    embed = direct(key("embed_tokens.weight"), dtype)
    params: Params = {
        "embed": _qe(embed) if qmode else embed,
        "final_norm": direct(key("norm.weight"), jnp.float32),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w8(key("lm_head.weight"))

    for i in range(cfg.num_layers):
        p = key(f"layers.{i}")
        layer: Dict[str, Any] = {
            "attn_norm": direct(f"{p}.input_layernorm.weight", jnp.float32),
            "mlp_norm": direct(
                f"{p}.post_attention_layernorm.weight", jnp.float32
            ),
            "wq": w(f"{p}.self_attn.q_proj.weight"),
            "wk": w(f"{p}.self_attn.k_proj.weight"),
            "wv": w(f"{p}.self_attn.v_proj.weight"),
            "wo": w(f"{p}.self_attn.o_proj.weight"),
        }
        if cfg.qkv_bias:
            layer["bq"] = direct(f"{p}.self_attn.q_proj.bias", dtype)
            layer["bk"] = direct(f"{p}.self_attn.k_proj.bias", dtype)
            layer["bv"] = direct(f"{p}.self_attn.v_proj.bias", dtype)
        if cfg.num_experts > 0:
            # Mixtral: w1 = gate, w3 = up, w2 = down; router stays fp32.
            # Expert stacks are quantized as one 3-D matrix (per-expert
            # per-output-channel scales), int8 regardless of qmode.
            moe = f"{p}.block_sparse_moe"

            def stack(hf_key):
                s = jnp.stack(
                    [
                        jnp.asarray(
                            _to_np(sd[f"{moe}.experts.{j}.{hf_key}.weight"]).T,
                            dtype,
                        )
                        for j in range(cfg.num_experts)
                    ]
                )
                return _q8(s) if qmode else s

            layer["moe"] = {
                "w_router": jnp.asarray(
                    _to_np(sd[f"{moe}.gate.weight"]).T, jnp.float32
                ),
                "w_gate": stack("w1"),
                "w_up": stack("w3"),
                "w_down": stack("w2"),
            }
        else:
            layer["w_gate"] = w(f"{p}.mlp.gate_proj.weight")
            layer["w_up"] = w(f"{p}.mlp.up_proj.weight")
            layer["w_down"] = w(f"{p}.mlp.down_proj.weight")
        params["layers"].append(layer)
    return params


def _cfg_with_detected_bias(cfg: LlamaConfig, sd: Mapping[str, Any]):
    """The state dict is the ground truth for q/k/v biases (Qwen2 carries
    them with no config flag)."""
    if not cfg.qkv_bias and _has_qkv_bias(sd):
        return dataclasses.replace(cfg, qkv_bias=True)
    return cfg


def load_hf_model(model: Any, dtype=None) -> tuple:
    """(params, cfg) from an in-memory transformers model instance."""
    sd = model.state_dict()
    cfg = _cfg_with_detected_bias(config_from_hf(model.config), sd)
    return params_from_hf(sd, cfg, dtype=dtype), cfg


def load_hf_checkpoint(
    path: str, dtype=None, quantize_weights=False, **config_overrides
) -> tuple:
    """(params, cfg) from an on-disk HF checkpoint directory
    (``config.json`` + ``*.safetensors``, sharded or single-file).

    No torch/transformers needed — safetensors' numpy backend reads the
    tensors directly, so 8B-class checkpoints load without a second
    framework resident in memory.
    """
    import json
    import pathlib

    from safetensors import numpy as st_np

    root = pathlib.Path(path)
    hf_config = json.loads((root / "config.json").read_text())
    cfg = config_from_hf(hf_config, **config_overrides)

    sd: Dict[str, np.ndarray] = {}
    files = sorted(root.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for f in files:
        sd.update(st_np.load_file(str(f)))
    cfg = _cfg_with_detected_bias(cfg, sd)
    # w8a16 (True or "int8"): int8 per-output-channel weights — what
    # lets an 8B-class model fit one 16 GB chip beside its cache.
    # "int4": group-wise w4a16 decoder projections (half the bytes
    # again; embedding/lm_head stay int8) — models/quantized.py.
    # Quantization streams tensor-by-tensor inside params_from_hf (the
    # full-precision tree would not fit HBM at 8B scale).
    params = params_from_hf(sd, cfg, dtype=dtype, quantize=quantize_weights)
    return params, cfg
