"""Stepwise versus burst decoding on the slots backend.

``run_to_completion(decode_burst=N)`` runs N decode steps in one jitted
``lax.scan`` with on-device sampling, EOS and budget handling; without a
burst the engine runs one jitted decode step per token.  Both must emit the
same tokens.  The output head is scaled up so that greedy argmax has clear
margins and no near-tie can flip between the two programs' float
reduction orders.
"""

import jax
import jax.numpy as jnp
import pytest

from quantumattention_tpu.models import llama, quantized
from quantumattention_tpu.serving.engine import Engine

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], [1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9],
           [6, 6, 6]]


def _params(cfg, weights):
    key = jax.random.PRNGKey(0)
    if weights == "w8a16":
        p = quantized.fuse_projections(quantized.init_quantized_params(key, cfg))
        p["lm_head"] = dict(p["lm_head"], s=p["lm_head"]["s"] * 50.0)
        return p
    p = llama.init_params(key, cfg)
    p["lm_head"] = p["lm_head"] * 50.0
    return p


CASES = {
    "int8": dict(),
    "bf16-cache": dict(cache_dtype=jnp.bfloat16),
    "int4-cache": dict(kv_int4=True),
    "window": dict(cfg=dict(window=6)),
    "w8a16": dict(weights="w8a16"),
    "budgets": dict(new_tokens=[3, 9, 1, 6]),
    "eos": dict(eos=True),
    "single-slot": dict(num_slots=1, prompts=PROMPTS[:1]),
    "long-burst": dict(burst=32, new_tokens=[20, 20, 20, 20]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_and_burst_emit_same_tokens(name):
    case = CASES[name]
    cfg = llama.tiny(attention_impl="sdpa", dtype=jnp.float32,
                     **case.get("cfg", {}))
    params = _params(cfg, case.get("weights", "full"))
    prompts = case.get("prompts", PROMPTS)
    budgets = case.get("new_tokens", [8] * len(prompts))

    def serve(burst):
        eng = Engine(
            params, cfg, num_slots=case.get("num_slots", 4), max_len=64,
            cache_dtype=case.get("cache_dtype", jnp.int8),
            kv_int4=case.get("kv_int4", False),
        )
        eos = None
        if case.get("eos"):
            # The first emitted token of request 0 becomes EOS for all:
            # requests that later emit it stop early.
            probe = Engine(params, cfg, num_slots=1, max_len=64)
            r = probe.submit(prompts[0], max_new_tokens=2)
            probe.run_to_completion()
            eos = r.output[1]
        reqs = [eng.submit(p, max_new_tokens=n, eos_id=eos)
                for p, n in zip(prompts, budgets)]
        eng.run_to_completion(decode_burst=burst)
        assert all(r.done for r in reqs)
        return [r.output for r in reqs]

    stepwise = serve(None)
    bursts = serve(case.get("burst", 8))
    assert stepwise == bursts
    if not case.get("eos"):
        assert [len(o) for o in stepwise] == budgets
