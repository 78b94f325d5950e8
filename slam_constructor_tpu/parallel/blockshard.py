"""Region-sharded block-pool map: tile-table bands as the unit of
multi-device map ownership.

SURVEY.md §2.3 marks the block-pool map (``LazyTiledGridMap`` equivalent,
``src/core/maps/lazy_tiled_grid_map.h`` [unverified]) as "the unit of
multi-host sharding"; §2.9's TP row requires "block-table ownership map +
halo exchange of boundary blocks". ``parallel/halo.py`` demonstrates the
halo pattern on a dense row-sharded plane; this module applies it to the
PRIMARY map representation itself:

- The tile table ``[TH, TW]`` is split row-wise over a mesh axis: device
  ``d`` owns tile rows ``[d*THl, (d+1)*THl)`` and a PRIVATE pool shard.
  Blocks of a band exist only on their owner — aggregate pool capacity
  scales with the number of devices (the point of sharding the map).
- **Insertion needs no communication.** Every observation cell belongs to
  exactly one band. Each device rasterizes the scan (replicated FLOPs —
  O(beams x samples), tiny next to the scatter) and scatters only the rows
  it owns into its local pool, allocating tiles locally via the same
  jit-safe cumsum as the single-device map.
- **Scoring exchanges halos.** Each device densifies its band's occupancy
  plane, swaps ``halo`` boundary rows with its ring neighbors via
  ``ppermute`` (neighbor traffic only), scores the scan endpoints whose
  center rows it owns, and a ``psum`` combines partial weighted sums —
  equal to the unsharded block-map scorer for any window radius <= halo
  (golden-tested in tests/test_parallel.py).

State layout (global view; shard these arrays with ``state_sharding``):
``pool f32[D, N, B, B, C]`` leading axis over the mesh, ``table
i32[TH, TW]`` tile rows over the mesh with LOCAL slot ids, ``n_alloc
i32[D]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import struct
from ..ops import blockmap as bmlib
from ..ops import raycast
from ..ops import scan as scanlib
from ..ops.geometry import apply_pose
from ..ops.scoring import ScoringConfig, _window_offsets
from .halo import (
    _exchange_rows,
    _ext_point_probs_matmul,
    _reduce_point_probs,
    _use_matmul,
)

Array = jax.Array


@struct.dataclass
class ShardedBlockMap:
    pool: Array  # f32[D, N, B, B, C] per-device pool shards
    table: Array  # i32[TH, TW] LOCAL slot per tile (-1 = unallocated)
    n_alloc: Array  # i32[D] blocks allocated per shard
    origin: Array  # f32[2] world coords of cell (0, 0)
    scale: float = struct.field(pytree_node=False)
    block: int = struct.field(pytree_node=False)

    @property
    def n_shards(self) -> int:
        return self.pool.shape[0]

    @property
    def height(self) -> int:
        return self.table.shape[0] * self.block

    @property
    def width(self) -> int:
        return self.table.shape[1] * self.block

    @property
    def overflowed(self) -> Array:
        return (self.n_alloc > self.pool.shape[1]).any()


def make_sharded_block_map(
    model,
    tiles_h: int,
    tiles_w: int,
    capacity_per_shard: int,
    n_shards: int,
    block: int = 32,
    scale: float = 0.1,
    origin: tuple[float, float] | None = None,
) -> ShardedBlockMap:
    assert tiles_h % n_shards == 0, "tile rows must divide the mesh axis"
    c = model.n_channels + 1
    init = jnp.concatenate(
        [jnp.asarray(model.init_belief(), jnp.float32), jnp.zeros((1,))]
    )
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    return ShardedBlockMap(
        pool=jnp.broadcast_to(
            init, (n_shards, capacity_per_shard, block, block, c)
        ).copy(),
        table=jnp.full((tiles_h, tiles_w), -1, jnp.int32),
        n_alloc=jnp.zeros((n_shards,), jnp.int32),
        origin=jnp.asarray(origin, jnp.float32),
        scale=float(scale),
        block=block,
    )


def state_sharding(sbm: ShardedBlockMap, mesh: Mesh, axis: str = "chips"):
    """Shardings placing each pool shard + tile band on its owner device
    (same pytree structure as ``sbm`` — usable as jit in/out_shardings)."""
    return sbm.replace(
        pool=NamedSharding(mesh, P(axis)),
        table=NamedSharding(mesh, P(axis, None)),
        n_alloc=NamedSharding(mesh, P(axis)),
        origin=NamedSharding(mesh, P()),
    )


def place(sbm: ShardedBlockMap, mesh: Mesh, axis: str = "chips") -> ShardedBlockMap:
    """device_put the state onto its owner devices."""
    sh = state_sharding(sbm, mesh, axis)
    return jax.tree.map(jax.device_put, sbm, sh)


def insert_scan(
    sbm: ShardedBlockMap,
    model,
    pose: Array,
    scan: scanlib.LaserScan,
    cfg: raycast.BeamConfig,
    mesh: Mesh,
    axis: str = "chips",
) -> ShardedBlockMap:
    """Communication-free sharded insertion: each device keeps the samples
    landing in its band and reuses the single-device allocate + scatter."""
    n_dev = mesh.shape[axis]
    th = sbm.table.shape[0]
    th_local = th // n_dev
    rows_local_band = th_local * sbm.block

    def kernel(pool, table, n_alloc, origin, pose_, scan_):
        d = jax.lax.axis_index(axis)
        row0 = d * rows_local_band
        local_origin = origin + jnp.stack(
            [jnp.float32(0.0), row0.astype(jnp.float32) * sbm.scale]
        )
        bm = bmlib.BlockMap(
            pool=pool[0], table=table, n_alloc=n_alloc[0],
            origin=local_origin, scale=sbm.scale, block=sbm.block,
        )
        rows, cols, w, s = raycast.scan_sample_cells(
            origin, sbm.scale, pose_, scan_, cfg
        )
        lrows = rows - row0
        own = (lrows >= 0) & (lrows < rows_local_band)
        bm = bmlib.scatter_observations(
            bm, model, lrows, cols, jnp.where(own, w, 0.0), s
        )
        return bm.pool[None], bm.table, bm.n_alloc[None]

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None), P(axis), P(None), P(None), P(None)),
        out_specs=(P(axis), P(axis, None), P(axis)),
        check_vma=False,
    )
    pool, table, n_alloc = fn(
        sbm.pool, sbm.table, sbm.n_alloc, sbm.origin, pose, scan
    )
    return sbm.replace(pool=pool, table=table, n_alloc=n_alloc)


def _band_value_plane(sbm, model, pool, table, unknown_prob) -> Array:
    """Densify one device's band into its occupancy-value plane [Hl, W]."""
    b = sbm.block
    th_l, tw = table.shape
    init = jnp.concatenate(
        [jnp.asarray(model.init_belief(), jnp.float32), jnp.zeros((1,))]
    )
    blocks = jnp.where(
        (table >= 0)[..., None, None, None],
        pool[jnp.clip(table, 0, pool.shape[0] - 1)],
        init,
    )  # [THl, TW, B, B, C]
    dense = blocks.transpose(0, 2, 1, 3, 4).reshape(th_l * b, tw * b, -1)
    occ = model.occupancy(dense[..., :-1])
    known = dense[..., -1] > 0.0
    return jnp.where(known, occ, unknown_prob)


def score_poses(
    sbm: ShardedBlockMap,
    model,
    scan: scanlib.LaserScan,
    poses: Array,
    cfg: ScoringConfig,
    mesh: Mesh,
    axis: str = "chips",
    halo: int | None = None,
) -> Array:
    """Sharded scan-likelihood over the block map: densify bands, ppermute
    ``halo`` boundary rows, score owned endpoints, psum partial sums.

    Supports all four reducers — obstacle / max / mean / overlap (the
    window reads that need halos). Equal to scoring the unsharded map for window <= halo.
    """
    n_dev = mesh.shape[axis]
    h, w = sbm.height, sbm.width
    h_local = h // n_dev
    r = 0 if cfg.reducer == "obstacle" else cfg.window
    halo = halo if halo is not None else max(r, 1)
    offs = (
        _window_offsets(cfg.window)
        if cfg.reducer != "obstacle"
        else jnp.zeros((1, 2), jnp.int32)
    )
    mask = scanlib.subsample_mask(scan, cfg.stride).astype(jnp.float32)
    pts = scanlib.scan_points(scan)

    def kernel(pool, table, origin, poses_, pts_, mask_):
        d = jax.lax.axis_index(axis)
        row0 = d * h_local
        plane = _band_value_plane(sbm, model, pool[0], table, cfg.unknown_prob)
        ext = _exchange_rows(plane, halo, axis)  # [Hl + 2*halo, W]

        world = apply_pose(poses_[:, None, :], pts_[None, :, :])  # [K, R, 2]
        rel = (world - origin) / sbm.scale
        col = jnp.floor(rel[..., 0]).astype(jnp.int32)
        row = jnp.floor(rel[..., 1]).astype(jnp.int32)
        row_own = jnp.clip(row, 0, h - 1)
        own = (row_own >= row0) & (row_own < row0 + h_local)

        if _use_matmul(cfg):
            # opt-in one-hot matmul sampling against the halo-extended
            # band (impl='matmul')
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

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None), P(None), P(None), P(None), P(None)),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(sbm.pool, sbm.table, sbm.origin, poses, pts, mask)


def gather_value_plane(
    sbm: ShardedBlockMap,
    model,
    mesh: Mesh,
    axis: str = "chips",
    unknown_prob: float = 0.5,
) -> Array:
    """Full dense value plane [H, W] (band-stacked) — export / golden tests."""

    def kernel(pool, table):
        return _band_value_plane(sbm, model, pool[0], table, unknown_prob)

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None)),
        out_specs=P(axis, None),
        check_vma=False,
    )
    return fn(sbm.pool, sbm.table)


def allocated_per_shard(sbm: ShardedBlockMap) -> Array:
    return sbm.n_alloc
