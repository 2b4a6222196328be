"""Test configuration: an 8-virtual-device CPU platform by default.

The sharding tests run the same SPMD program on a virtual 8-device CPU
mesh (SURVEY.md §4.2(5)). The platform is a default, not an override: set
``JAX_PLATFORMS=cuda,cpu`` to run the ``gpu``-marked tests on a card. The
environment must be set before jax initializes its backends.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from ccs_tpu.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU visible to JAX (run with JAX_PLATFORMS=cuda,cpu "
                    "on a machine with a card)")
    return devs[0]
