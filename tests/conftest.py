"""Test configuration: CPU backend with 8 virtual devices, float64.

Tests always run on an 8-device virtual CPU mesh (the cheap analog of a
multi-chip TPU slice — sharding tests exercise the same shard_map code path
that runs on real hardware) in float64, matching the reference's PETSc
double-precision tolerances. Bench runs use the real TPU chip separately.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
