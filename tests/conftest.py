"""Test harness: force the CPU backend with 8 virtual devices so sharding
logic is exercised without accelerators (SURVEY.md §4 "distributed tests").

Must run before anything imports jax — pytest imports conftest first.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
