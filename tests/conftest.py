"""Test bootstrap: run everything on a virtual 8-device CPU mesh.

Pallas kernels run in interpret mode on CPU (config.interpret == "auto"), so
the full suite — including multi-device sharding tests — runs without a
GPU.  ``QUANTUM_ATTN_TEST_GPU=1`` leaves JAX on its default platform, for
the ``gpu``-marked tests on a card (``python -m pytest tests -m gpu``).
"""

import os

if os.environ.get("QUANTUM_ATTN_TEST_GPU") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
