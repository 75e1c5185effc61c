"""Compiled kernels on an NVIDIA GPU against the plain references.

Marked ``gpu``: they skip unless the tests run on a card, which takes
``QUANTUM_ATTN_TEST_GPU=1 python -m pytest tests -m gpu`` (tests/conftest.py
otherwise pins JAX to the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumattention_tpu as qa
from quantumattention_tpu.ops import quant
from quantumattention_tpu.ops.decode import decode_attention, decode_attention_plain
from quantumattention_tpu.ops.sdpa import sdpa_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (QUANTUM_ATTN_TEST_GPU=1 on a card)")


def _rmse(a, b):
    return float(np.sqrt(np.mean(
        (np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2)))


@pytest.mark.parametrize("scaling", [None, "head-wise", "token-wise", "per-block"])
def test_flash_compiled_matches_reference(gpu, scaling):
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(key, (2, 8, 2048, 128), jnp.float32)
               .astype(jnp.bfloat16) for key in keys)
    if scaling is None:
        out = qa.attn_func(q, k, v, is_causal=True)
    else:
        out = qa.fp8_attn_func(q, k, v, is_causal=True, scaling_method=scaling)
    ref = sdpa_reference(q, k, v, is_causal=True, out_dtype=jnp.float32)
    assert _rmse(out, ref) < 1e-2


def test_decode_compiled_matches_plain(gpu):
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    q = jax.random.normal(keys[0], (8, 32, 128), jnp.float32).astype(jnp.bfloat16)
    k8, ks = quant.quantize_token_wise(
        jax.random.normal(keys[1], (8, 8, 1024, 128)), jnp.int8)
    v8, vs = quant.quantize_token_wise(
        jax.random.normal(keys[2], (8, 8, 1024, 128)), jnp.int8)
    lengths = jnp.array([1024, 1, 0, 512, 700, 33, 1000, 128], jnp.int32)
    out = decode_attention(q, k8, v8, lengths, k_scale=ks, v_scale=vs)
    ref = decode_attention_plain(q, k8, v8, lengths, k_scale=ks, v_scale=vs)
    assert _rmse(out, ref) < 1e-3
