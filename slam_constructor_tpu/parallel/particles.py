"""Particle-axis parallelism for the RBPF (the DP/EP axes of SURVEY.md §2.9).

Two complementary mechanisms:

1. ``sharded_run`` — GSPMD path: shard every particle-major array of
   ``GMappingState`` over the mesh and jit the *unchanged* ``gmapping_step``.
   XLA inserts the collectives (the logsumexp for weight normalization
   becomes a cross-shard reduction; the resampling gather becomes an
   all-to-all of map blocks). Zero algorithm changes, exact same numerics.

2. ``psum_normalize_log_weights`` / ``sharded_neff`` — explicit shard_map
   building blocks (psum-based weight normalization per BASELINE), used by
   the multi-host driver where the particle axis spans processes and we want
   collectives pinned to the intra-host ``chips`` axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models import gmapping as gm_lib
from ..ops import resample

Array = jax.Array


def state_shardings(
    template: gm_lib.GMappingState, mesh: Mesh, axis: str = "particles"
):
    """Sharding pytree mirroring a GMappingState: particle-major arrays
    (maps, poses, weights) split over ``axis``; PRNG key + step replicated."""
    s_part = NamedSharding(mesh, P(axis))
    s_rep = NamedSharding(mesh, P())
    sh = jax.tree.map(lambda _: s_part, template)
    return sh.replace(key=s_rep, step=s_rep)


def shard_state(state: gm_lib.GMappingState, mesh: Mesh, axis: str = "particles"):
    """Place an existing state onto the mesh with particle-axis sharding."""
    return jax.device_put(state, state_shardings(state, mesh, axis))


def _template(cfg: gm_lib.GMappingConfig) -> gm_lib.GMappingState:
    return jax.eval_shape(lambda: gm_lib.init_state(cfg))


def make_sharded_step(cfg: gm_lib.GMappingConfig, mesh: Mesh, axis="particles"):
    """Jitted RBPF step with particle sharding constraints (GSPMD: XLA
    derives the cross-shard collectives; numerics match the local step)."""
    sh = state_shardings(_template(cfg), mesh, axis)
    rep = NamedSharding(mesh, P())

    return jax.jit(
        partial(gm_lib.gmapping_step, cfg),
        in_shardings=(sh, rep, rep),
        out_shardings=(sh, rep),  # (state, resample ancestors)
        donate_argnums=0,
    )


def make_sharded_run(cfg: gm_lib.GMappingConfig, mesh: Mesh, axis="particles"):
    """Jitted whole-sequence RBPF run under particle sharding."""
    sh = state_shardings(_template(cfg), mesh, axis)
    rep = NamedSharding(mesh, P())

    def run(state, scans, odom):
        return gm_lib.run_sequence(cfg, state, scans, odom)

    return jax.jit(
        run, in_shardings=(sh, rep, rep),
        out_shardings=(sh, rep, rep, rep, rep),
    )


# --- explicit shard_map collectives (multi-host building blocks) ------------


def psum_normalize_log_weights(
    logw: Array, mesh: Mesh, axis: str = "particles",
    deterministic: bool = False,
):
    """Cross-shard weight normalization: stable logsumexp via a psum'd max
    and a psum'd sum — the per-scan intra-host collective of the distributed RBPF.

    ``deterministic=True`` swaps the XLA all-reduce (association order is an
    implementation detail) for the fixed-order ladder reduction in
    ``utils.determinism`` — bitwise-reproducible across runs and device
    re-orderings, at an all-gather of P floats (negligible next to map
    traffic). Use it whenever the run claims bit-reproducibility.
    """
    if deterministic:
        from ..utils import determinism

        return determinism.deterministic_normalize_log_weights(logw, mesh, axis)

    def kernel(lw):
        local_max = jnp.max(lw)
        gmax = jax.lax.pmax(local_max, axis)
        local_sum = jnp.sum(jnp.exp(lw - gmax))
        gsum = jax.lax.psum(local_sum, axis)
        return lw - (gmax + jnp.log(gsum))

    return shard_map(
        kernel, mesh=mesh, in_specs=P(axis), out_specs=P(axis)
    )(logw)


def sharded_neff(logw: Array, mesh: Mesh, axis: str = "particles"):
    """Effective sample size with psum reduction (replicated scalar out)."""

    def kernel(lw):
        local_max = jnp.max(lw)
        gmax = jax.lax.pmax(local_max, axis)
        z = jax.lax.psum(jnp.sum(jnp.exp(lw - gmax)), axis)
        w2 = jax.lax.psum(jnp.sum(jnp.exp(2.0 * (lw - gmax))), axis)
        return (z * z / w2)[None]

    out = shard_map(
        kernel, mesh=mesh, in_specs=P(axis), out_specs=P(None)
    )(logw)
    return out[0]
