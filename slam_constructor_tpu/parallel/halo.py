"""Spatially-sharded map scoring with halo exchange (the TP axis of
SURVEY.md §2.9; BASELINE: "halo exchange for scan matching near block
boundaries").

The occupancy value plane is sharded row-wise over the mesh axis: device d
owns rows ``[d*Hl, (d+1)*Hl)``. Scoring a candidate pose needs a window of
``r`` cells around each scan endpoint, so endpoints within ``r`` rows of a
shard boundary read neighbor-owned cells. Instead of gathering the whole
plane, each device exchanges ``halo`` boundary rows with its two ring
neighbors via ``ppermute`` (neighbor traffic only), scores the
endpoints *it owns* against its extended local block, and a ``psum``
combines the per-point partial sums — bitwise-equal to the unsharded
scorer for any window radius <= halo.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import scan as scanlib
from ..ops.geometry import apply_pose
from ..ops.scoring import (
    MapView,
    ScoringConfig,
    _sample_matmul_chunked,
    _window_offsets,
)

Array = jax.Array


def _use_matmul(cfg: ScoringConfig) -> bool:
    return cfg.impl == "matmul" and cfg.reducer in ("obstacle", "mean", "overlap")


def _ext_point_probs_matmul(
    ext: Array, rel: Array, row0, halo: int, h: int, cfg: ScoringConfig
) -> Array:
    """Per-point probabilities [K, R] against a halo-extended local block
    (``impl='matmul'``) inside shard_map: the same separable one-hot / box /
    overlap sampling matmuls as the unsharded scorer, no vector gather.

    ``ext`` rows map to global rows ``row0 - halo + i``; wrap-around rows a
    ring ppermute delivers to edge shards fall outside the global map and
    are overwritten with ``unknown_prob`` (the gather path masks them via
    ``in_map``). Weight mass outside the block is backfilled with
    ``unknown_prob`` by the sampler's coverage term, which matches the
    unsharded matmul path's out-of-map semantics exactly — valid for owned
    points whose window rows lie within the halo (the caller's ownership
    rule guarantees this for window radius <= halo)."""
    hl_ext = ext.shape[0]
    grow = row0 - halo + jnp.arange(hl_ext)
    ext = jnp.where(((grow >= 0) & (grow < h))[:, None], ext, cfg.unknown_prob)
    rel_local = jnp.stack(
        [rel[..., 0], rel[..., 1] - (row0 - halo).astype(jnp.float32)], axis=-1
    )
    k, r = rel.shape[:2]
    return _sample_matmul_chunked(ext, rel_local.reshape(k * r, 2), cfg).reshape(k, r)


def _exchange_rows(block: Array, halo: int, axis: str) -> Array:
    """Append ``halo`` rows from the ring neighbors above and below.

    block: f32[Hl, W] -> f32[Hl + 2*halo, W]. Edge devices receive the
    wrap-around neighbor's rows; callers mask them out via global row
    bounds, so ring (vs. open-chain) wiring never changes results.
    """
    n = jax.lax.axis_size(axis)
    up = [(i, (i + 1) % n) for i in range(n)]  # send to next (rows below top)
    down = [(i, (i - 1) % n) for i in range(n)]
    # my top rows go to the device after me (they become its bottom halo)
    top_rows = block[-halo:, :]
    bot_rows = block[:halo, :]
    from_below = jax.lax.ppermute(top_rows, axis, up)  # rows of d-1's top
    from_above = jax.lax.ppermute(bot_rows, axis, down)  # rows of d+1's bottom
    return jnp.concatenate([from_below, block, from_above], axis=0)


def _reduce_point_probs(vals: Array, rel: Array, cfg: ScoringConfig) -> Array:
    """Reduce window values [K, R, W2] to per-point probabilities [K, R] —
    the same four reducers as the unsharded scorer (ops/scoring.py),
    including the overlap-weighted one (fractional endpoint-square overlap
    with each window cell, computed from the fractional coords ``rel``)."""
    if cfg.reducer == "max":
        return vals.max(-1)
    if cfg.reducer == "mean":
        return vals.mean(-1)
    if cfg.reducer == "overlap":
        offs = _window_offsets(cfg.window).astype(jnp.float32)
        frac = rel - jnp.floor(rel)  # [K, R, 2] (x, y)
        half = cfg.overlap_extent / 2.0
        exy = frac[:, :, None, :]
        cell_lo = jnp.stack([offs[..., 1], offs[..., 0]], axis=-1)  # (x, y)
        lo = jnp.maximum(cell_lo[None, None], exy - half)
        hi = jnp.minimum(cell_lo[None, None] + 1.0, exy + half)
        wh = jnp.clip(hi - lo, 0.0)
        wgt = wh[..., 0] * wh[..., 1]  # [K, R, W2]
        wsum = jnp.maximum(wgt.sum(-1, keepdims=True), 1e-9)
        return (vals * wgt).sum(-1) / wsum[..., 0]
    return vals[..., 0]  # obstacle


def sharded_score_poses(
    view: MapView,
    scan: scanlib.LaserScan,
    poses: Array,
    cfg: ScoringConfig,
    mesh: Mesh,
    axis: str = "chips",
    halo: int | None = None,
) -> Array:
    """Row-sharded equivalent of ``scoring.score_poses`` (all four
    reducers: obstacle / max / mean / overlap). The plane is split over ``axis``; each device scores the
    endpoints whose window rows it owns and psums partial results."""
    n_dev = mesh.shape[axis]
    h, w = view.occ.shape
    assert h % n_dev == 0, "plane rows must divide the mesh axis"
    h_local = h // n_dev
    r = 0 if cfg.reducer == "obstacle" else cfg.window
    halo = halo if halo is not None else max(r, 1)
    offs = _window_offsets(cfg.window) if cfg.reducer != "obstacle" else jnp.zeros((1, 2), jnp.int32)

    val_plane = jnp.where(view.known, view.occ, cfg.unknown_prob)
    mask = scanlib.subsample_mask(scan, cfg.stride).astype(jnp.float32)

    def kernel(plane_blk, poses_, pts_, mask_):
        d = jax.lax.axis_index(axis)
        ext = _exchange_rows(plane_blk, halo, axis)  # [Hl + 2*halo, W]
        row0 = d * h_local  # global row of plane_blk[0]

        world = apply_pose(poses_[:, None, :], pts_[None, :, :])  # [K, R, 2]
        rel = (world - view.origin) / view.scale
        col = jnp.floor(rel[..., 0]).astype(jnp.int32)
        row = jnp.floor(rel[..., 1]).astype(jnp.int32)

        # ownership: the endpoint's center row belongs to this device; rows
        # outside the map are assigned to the edge shard by clamping so that
        # every point is owned exactly once (off-map points must still
        # contribute unknown_prob, as in the unsharded scorer)
        row_own = jnp.clip(row, 0, h - 1)
        own = (row_own >= row0) & (row_own < row0 + h_local)

        if _use_matmul(cfg):
            point_p = _ext_point_probs_matmul(ext, rel, row0, halo, h, cfg)
        else:
            wrow = row[..., None] + offs[None, None, :, 0]
            wcol = col[..., None] + offs[None, None, :, 1]
            in_map = (wrow >= 0) & (wrow < h) & (wcol >= 0) & (wcol < w)
            lrow = jnp.clip(wrow - row0 + halo, 0, h_local + 2 * halo - 1)
            lcol = jnp.clip(wcol, 0, w - 1)
            vals = jnp.where(in_map, ext[lrow, lcol], cfg.unknown_prob)
            point_p = _reduce_point_probs(vals, rel, cfg)

        contrib = jnp.where(own, point_p * mask_[None, :], 0.0)
        num = jax.lax.psum(contrib.sum(-1), axis)
        den = jax.lax.psum(jnp.where(own, mask_[None, :], 0.0).sum(-1), axis)
        return num / jnp.maximum(den, 1e-9)

    pts = scanlib.scan_points(scan)
    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis, None), P(None), P(None), P(None)),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(val_plane, poses, pts, mask)


def beam_sharded_score_poses(
    view: MapView,
    scan: scanlib.LaserScan,
    poses: Array,
    cfg: ScoringConfig,
    mesh: Mesh,
    axis: str = "chips",
) -> Array:
    """Sequence-parallel scoring: the BEAM axis is sharded over the mesh
    (SURVEY.md §2.9 SP row — beams are independent given the pose, so each
    device scores its beam shard against a replicated map and one psum
    combines the weighted partial sums). Exact vs. the unsharded scorer.
    """
    n_dev = mesh.shape[axis]
    r = scan.n_beams
    assert r % n_dev == 0, "beam count must divide the mesh axis"
    val_plane = jnp.where(view.known, view.occ, cfg.unknown_prob)
    mask_full = scanlib.subsample_mask(scan, cfg.stride).astype(jnp.float32)
    pts = scanlib.scan_points(scan)
    h, w = view.occ.shape
    if cfg.reducer == "obstacle":
        offs = jnp.zeros((1, 2), jnp.int32)
    else:
        offs = _window_offsets(cfg.window)

    def kernel(plane, poses_, pts_, mask_):
        world = apply_pose(poses_[:, None, :], pts_[None, :, :])  # [K, Rl, 2]
        rel = (world - view.origin) / view.scale
        col = jnp.floor(rel[..., 0]).astype(jnp.int32)
        row = jnp.floor(rel[..., 1]).astype(jnp.int32)
        wrow = row[..., None] + offs[None, None, :, 0]
        wcol = col[..., None] + offs[None, None, :, 1]
        in_map = (wrow >= 0) & (wrow < h) & (wcol >= 0) & (wcol < w)
        vals = jnp.where(
            in_map,
            plane[jnp.clip(wrow, 0, h - 1), jnp.clip(wcol, 0, w - 1)],
            cfg.unknown_prob,
        )
        point_p = _reduce_point_probs(vals, rel, cfg)
        num = jax.lax.psum((point_p * mask_[None, :]).sum(-1), axis)
        den = jax.lax.psum(mask_.sum(), axis)
        return num / jnp.maximum(den, 1e-9)

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(None, None), P(None), P(axis, None), P(axis)),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(val_plane, poses, pts, mask_full)
