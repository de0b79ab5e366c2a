"""Test configuration: run on CPU with 8 virtual devices.

This replaces "testing multi-node without a cluster" (see SURVEY.md §4):
multi-device sharding tests execute on a virtual 8-device CPU mesh via
``xla_force_host_platform_device_count``.  Must be set before jax
initializes a backend, hence module-level here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# a platform plugin may set jax_platforms itself; force CPU regardless
jax.config.update("jax_platforms", "cpu")
