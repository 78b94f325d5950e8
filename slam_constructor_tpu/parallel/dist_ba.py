"""Distributed pose-graph solve: edge-sharded normal equations over
collectives (BASELINE: "distributed bundle-adjustment-style Schur-complement
reduction over collectives"; the "hosts" axis of SURVEY.md §2.9).

Each device owns a contiguous shard of the edge table, assembles its partial
normal equations ``H_p = sum J^T W J`` and ``b_p = sum J^T W e`` over local
edges, and a single ``psum`` reduces them; the (small, dense) reduced system
is then solved identically on every device — optionally through the
Schur-complement block elimination so only the active-keyframe block is
factored. Runs at loop-closure rate, so the psum may cross hosts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models import posegraph as pg
from ..ops.geometry import wrap_angle

Array = jax.Array


def _partial_normal_equations(
    poses: Array, ei: Array, ej: Array, ez: Array, einfo: Array, emask: Array,
    eloop: Array, kmax: int, huber_delta: float,
):
    """Assemble H, b from a shard of edges (same math as posegraph.optimize,
    including the Huber robust kernel on loop edges)."""
    n_dof = 3 * kmax

    def per_edge(i, j, z, info, m, is_loop):
        e, ji, jj = pg._edge_residual_jac(poses[i], poses[j], z)
        w = info * m
        if huber_delta > 0:
            chi = jnp.sqrt(jnp.maximum((w * e * e).sum(), 1e-12))
            rw = jnp.minimum(1.0, huber_delta / chi)
            w = w * jnp.where(is_loop, rw, 1.0)
        return (
            pg._mm(ji.T * w, ji), pg._mm(ji.T * w, jj), pg._mm(jj.T * w, jj),
            pg._mm(ji.T, w * e), pg._mm(jj.T, w * e),
        )

    hii, hij, hjj, bi, bj = jax.vmap(per_edge)(ei, ej, ez, einfo, emask, eloop)
    h = jnp.zeros((n_dof, n_dof))
    b = jnp.zeros((n_dof,))
    r3 = jnp.arange(3)
    ri = (3 * ei)[:, None] + r3[None, :]
    rj = (3 * ej)[:, None] + r3[None, :]

    def blocks(h, rows, cols, vals):
        return h.at[rows[:, :, None], cols[:, None, :]].add(vals)

    h = blocks(h, ri, ri, hii)
    h = blocks(h, ri, rj, hij)
    h = blocks(h, rj, ri, jnp.swapaxes(hij, 1, 2))
    h = blocks(h, rj, rj, hjj)
    b = b.at[ri].add(bi).at[rj].add(bj)
    return h, b


def distributed_optimize(
    cfg: pg.PoseGraphConfig,
    st: pg.PoseGraphState,
    mesh: Mesh,
    axis: str = "hosts",
    schur_split: int | None = None,
) -> pg.PoseGraphState:
    """Gauss-Newton with edge-sharded assembly + psum reduction.

    Numerically equivalent to ``posegraph.optimize`` (up to float reduction
    order). ``schur_split`` (in keyframes) switches the replicated solve to
    Schur block elimination.
    """
    n_dev = mesh.shape[axis]
    e_total = st.edge_i.shape[0]
    assert e_total % n_dev == 0, "edge capacity must divide the mesh axis"
    kmax = cfg.max_keyframes
    e_idx = jnp.arange(e_total)
    e_mask = (e_idx < st.n_edges).astype(jnp.float32)

    def gn_iter(_, poses):
        def kernel(ei, ej, ez, einfo, emask, eloop):
            h_p, b_p = _partial_normal_equations(
                poses, ei, ej, ez, einfo, emask, eloop, kmax, cfg.huber_delta
            )
            h = jax.lax.psum(h_p, axis)
            b = jax.lax.psum(b_p, axis)
            return h[None], b[None]

        h, b = shard_map(
            kernel,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(None), P(None)),
            check_vma=False,
        )(st.edge_i, st.edge_j, st.edge_delta, st.edge_info, e_mask,
          st.edge_is_loop)
        h, b = h[0], b[0]

        kf_used = (jnp.arange(kmax) < st.n_kf) & (jnp.arange(kmax) > 0)
        dof_used = jnp.repeat(kf_used, 3)
        h = jnp.where(dof_used[:, None] & dof_used[None, :], h, 0.0)
        h = h + jnp.diag(jnp.where(dof_used, cfg.gn_damping, 1.0))
        b = jnp.where(dof_used, b, 0.0)

        if schur_split is not None:
            dx = pg.schur_solve(h, -b, 3 * schur_split)
        else:
            dx = jnp.linalg.solve(h, -b)
        new = poses + dx.reshape(kmax, 3)
        return new.at[:, 2].set(wrap_angle(new[:, 2]))

    poses = jax.lax.fori_loop(0, cfg.gn_iterations, gn_iter, st.kf_poses)
    return st.replace(kf_poses=poses)
