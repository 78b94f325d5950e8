"""Multi-host runtime: process-group init, failure detection, recovery.

SURVEY.md §5: the reference has no failure story (single process). The
plan: ``jax.distributed`` process groups across hosts; liveness
checked by running a deadline-guarded collective; recovery = restart the
process group and restore every engine state from the last checkpoint
(states are pure pytrees — see utils/checkpoint, which is why recovery is
"load + continue" with bit-identical semantics).

Single-host sessions (including the CI mesh of 8 virtual CPU devices) run
the same code with ``n_processes == 1`` — collectives over the in-process
mesh. Multi-process behavior requires real multi-host launch; the API is
kept total so the driver's dryrun exercises it unmodified.
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Join the process group (no-op for single-process runs).

    Reads JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    arguments are omitted — the launcher contract.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    if num_processes > 1 and coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_id": getattr(jax, "process_index", lambda: 0)(),
        "num_processes": getattr(jax, "process_count", lambda: 1)(),
        "devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
    }


def heartbeat(mesh, axis: str = "hosts", timeout_s: float = 30.0) -> bool:
    """Liveness probe: a tiny psum across ``axis`` under a deadline.

    Returns False (suspected peer failure) if the collective does not
    complete in time — the signal the driver uses to trigger recovery.

    The probe runs on a DAEMON thread: when a peer is dead the collective
    never completes, and anything that joins that thread (a
    ThreadPoolExecutor context exit, interpreter shutdown of a non-daemon
    thread) would hang the *surviving* process right when it must act —
    found by the fault-injection test (tests/test_multiprocess.py). After a
    False return the process group is wedged; callers should checkpoint
    state they own and exit so the launcher can restart the group.
    """
    import threading

    n = mesh.shape[axis]
    result: list = []
    f = _heartbeat_probe(mesh, axis)

    def probe():
        result.append(float(np.asarray(f())))

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return bool(result) and result[0] == float(n)


@functools.lru_cache(maxsize=8)
def _heartbeat_probe(mesh, axis: str):
    """Cached jitted probe for ``heartbeat`` (the monitoring hot path runs
    every step — re-jitting a fresh closure per call would retrace).

    The input is materialized ON the mesh inside jit: a host-local array
    fed to a multi-host computation is not a global jax.Array (the round-1
    probe failed exactly there in real multi-process runs). The sharded sum
    lowers to a cross-process all-reduce; the replicated output is
    addressable on every process."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.shape[axis]

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def f():
        x = jax.lax.with_sharding_constraint(
            jnp.ones((n,), jnp.float32), NamedSharding(mesh, P(axis))
        )
        return x.sum()

    return f


class RecoveryLoop:
    """Checkpoint-based elastic recovery driver.

    Usage:
        loop = RecoveryLoop(ckpt_path, template_state, save_every=100)
        state = loop.restore_or(init_state)
        for scan in stream:
            state = step(state, scan)
            loop.tick(state)

    On a detected failure, the launcher restarts the job; the next run's
    ``restore_or`` resumes from the last snapshot deterministically.
    """

    def __init__(self, path: str, save_every: int = 100):
        self.path = path
        self.save_every = save_every
        self._count = 0

    def restore_or(self, template, init_fn):
        from ..utils import checkpoint

        for candidate in (self.path, self.path + ".npz"):
            if os.path.exists(candidate):
                return checkpoint.restore(candidate, template), True
        return init_fn(), False

    def tick(self, state) -> None:
        from ..utils import checkpoint

        self._count += 1
        if self._count % self.save_every == 0:
            tmp = self.path + ".tmp"
            checkpoint.save(tmp, state)
            os.replace(tmp + ".npz", self.path + ".npz")
