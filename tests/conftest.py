"""Test harness: run JAX on CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh (the standard
JAX pattern, SURVEY.md §4d).  The Triton kernel runs in the Pallas
interpreter here; nothing in this suite needs the GPU.  On the card the
kernel, the CLI and the four-card paths are checked by ``chip_smoke.py``
(``python chip_smoke.py``, ``python chip_smoke.py --four-cards``).

The platform is pinned through the config rather than the environment,
so a GPU-enabled JAX also runs the suite on the CPU (backends are not
initialized until first use, so this is safe here).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from remap_tpu.utils.runtime import setup_cache  # noqa: E402

setup_cache()

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: ``-m quick`` is the fast, full-coverage tier.

    Everything under tests/differential/ (compiled-reference oracles) is
    slow by construction; other tests are quick unless explicitly marked
    ``slow`` (the scale/invariance batteries whose mechanisms are also
    covered by a faster test).  Expected walls in docs/USAGE.md."""
    for item in items:
        if "differential" in str(item.path):
            item.add_marker(pytest.mark.slow)
        elif item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.quick)
