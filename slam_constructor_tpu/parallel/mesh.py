"""Device-mesh helpers for the distributed engine.

The reference is single-process/single-thread (SURVEY.md §2.9) — this whole
layer is new capability. Axis conventions:

- ``"hosts"``  — cross-host axis: keyframe ranges for distributed BA, map
  region ownership. Collectives on it run at loop-closure rate only.
- ``"chips"`` — intra-host axis (NVLink between the devices of one
  host): particles / candidate poses / map-block halos. Collectives on it
  run every scan.

On a single host both axes live on one slice; tests fold everything onto
``chips`` with hosts=1 (or use the flat ``particles`` axis).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_hosts: int | None = None, n_chips: int | None = None, devices=None
) -> Mesh:
    """Build a ("hosts", "chips") mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_hosts is None:
        n_hosts = getattr(jax, "process_count", lambda: 1)()
        if n % n_hosts != 0:
            n_hosts = 1
    if n_chips is None:
        n_chips = n // n_hosts
    arr = np.asarray(devices[: n_hosts * n_chips]).reshape(n_hosts, n_chips)
    return Mesh(arr, ("hosts", "chips"))


def flat_mesh(axis: str = "particles", devices=None) -> Mesh:
    """1D mesh over every device — the single-axis sharding tests use."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_leading(mesh: Mesh, axis_name: str):
    """NamedSharding that splits the leading array axis over ``axis_name``."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
