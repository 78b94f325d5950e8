"""Block-pool tiled occupancy map: the sparse/unbounded map representation.

Parity targets (SURVEY.md §2.3 [unverified]): ``LazyTiledGridMap`` /
``UnboundedLazyTiledGridMap`` (``src/core/maps/lazy_tiled_grid_map.h``) —
tile-based sparse storage with default-cell sharing, growing on demand.

Re-design for XLA static shapes: a fixed-capacity *block pool*
``f32[N, B, B, C]`` plus an int32 *block table* mapping tile coordinates to
pool slots (-1 = unallocated, reads as the init cell). Allocation happens
INSIDE jit with a cumsum over newly-touched tiles — no reallocation, no
host round trip; pool exhaustion sets an overflow flag the host driver can
react to (re-shard event), mirroring how dense-map growth works.

Scoring reads through ``extract_window``: the B-aligned region around the
robot is gathered from the pool into a dense plane so every matcher/scorer
(including the matmul sampling path) runs unchanged. The block table is also
the unit of multi-host map sharding and of copy-on-write particle maps
(tables are copied, blocks shared) — see SURVEY.md §2.9.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import struct
from . import grid as gridlib
from .cells import init_cell as _model_init_cell

Array = jax.Array


@struct.dataclass
class BlockMap:
    pool: Array  # f32[N, B, B, C] allocated blocks (C = belief + weight)
    table: Array  # i32[TH, TW] pool slot per tile, -1 = unallocated
    n_alloc: Array  # i32[] blocks allocated so far
    origin: Array  # f32[2] world coords of table corner (tile 0,0 / cell 0,0)
    scale: float = struct.field(pytree_node=False)
    block: int = struct.field(pytree_node=False)

    @property
    def capacity(self) -> int:
        return self.pool.shape[0]

    @property
    def height(self) -> int:
        return self.table.shape[0] * self.block

    @property
    def width(self) -> int:
        return self.table.shape[1] * self.block

    @property
    def overflowed(self) -> Array:
        return self.n_alloc > self.capacity


def make_block_map(
    model,
    tiles_h: int,
    tiles_w: int,
    capacity: int,
    block: int = 32,
    scale: float = 0.1,
    origin: tuple[float, float] | None = None,
) -> BlockMap:
    c = model.n_channels + 1
    pool = jnp.broadcast_to(
        _model_init_cell(model), (capacity, block, block, c)
    ).copy()
    if origin is None:
        origin = (
            -tiles_w * block * scale / 2.0,
            -tiles_h * block * scale / 2.0,
        )
    return BlockMap(
        pool=pool,
        table=jnp.full((tiles_h, tiles_w), -1, jnp.int32),
        n_alloc=jnp.int32(0),
        origin=jnp.asarray(origin, jnp.float32),
        scale=float(scale),
        block=block,
    )


def allocate_tiles(bm: BlockMap, needed: Array) -> BlockMap:
    """Allocate pool slots for tiles where ``needed`` (bool[TH, TW]) is set
    and the table has no block yet. Pure, fixed shapes.

    At pool exhaustion the tile stays UNALLOCATED (-1): it keeps reading as
    the init cell and its writes are dropped, while ``n_alloc`` counts the
    demand so ``overflowed`` latches. (Storing the out-of-capacity slot id
    would make readers clip it onto an unrelated tile's block.)"""
    new = needed & (bm.table < 0)
    flat = new.ravel()
    slots = bm.n_alloc + jnp.cumsum(flat.astype(jnp.int32)) - 1
    slots = jnp.where(slots < bm.capacity, slots, -1)
    slots = jnp.where(flat, slots, bm.table.ravel())
    return bm.replace(
        table=slots.reshape(bm.table.shape).astype(jnp.int32),
        n_alloc=bm.n_alloc + flat.sum(dtype=jnp.int32),
    )


def cells_to_slots(bm: BlockMap, rows: Array, cols: Array):
    """Cell coords -> (pool slot, in-block row, in-block col, valid)."""
    b = bm.block
    tr, rr = rows // b, rows % b
    tc, cc = cols // b, cols % b
    th, tw = bm.table.shape
    ok = (tr >= 0) & (tr < th) & (tc >= 0) & (tc < tw)
    slot = jnp.where(ok, bm.table[jnp.clip(tr, 0, th - 1), jnp.clip(tc, 0, tw - 1)], -1)
    return slot, rr, cc, ok & (slot >= 0)


def scatter_observations(
    bm: BlockMap, model, rows: Array, cols: Array, w: Array, s: Array
) -> BlockMap:
    """Accumulate observation (weight, occupancy-sum) pairs at cell coords
    into the pool and apply the cell-model fold on touched blocks only."""
    b = bm.block
    th, tw = bm.table.shape
    # 1. allocate tiles touched by any valid observation
    tr = jnp.clip(rows // b, 0, th - 1)
    tc = jnp.clip(cols // b, 0, tw - 1)
    valid = (w > 0) & (rows >= 0) & (rows < th * b) & (cols >= 0) & (cols < tw * b)
    touched = jnp.zeros((th, tw), bool).at[tr, tc].max(valid, mode="drop")
    bm = allocate_tiles(bm, touched)

    # 2. scatter into pool-linearized planes
    slot, rr, cc, ok = cells_to_slots(bm, rows, cols)
    n, bb = bm.capacity, b * b
    lin = jnp.where(ok & valid, slot * bb + rr * b + cc, -1)
    w_flat = jnp.zeros((n * bb,), jnp.float32).at[lin.ravel()].add(
        jnp.where(valid, w, 0.0).ravel(), mode="drop"
    )
    s_flat = jnp.zeros((n * bb,), jnp.float32).at[lin.ravel()].add(
        jnp.where(valid, s, 0.0).ravel(), mode="drop"
    )
    w_obs = w_flat.reshape(n, b, b)
    s_obs = s_flat.reshape(n, b, b)

    # 3. cell-model fold over the pool (elementwise; untouched blocks no-op)
    belief = bm.pool[..., :-1]
    n_prev = bm.pool[..., -1]
    new_belief = model.update(belief, n_prev, w_obs, s_obs)
    pool = jnp.concatenate([new_belief, (n_prev + w_obs)[..., None]], axis=-1)
    return bm.replace(pool=pool)


def insert_scan(bm: BlockMap, model, pose: Array, scan, cfg) -> BlockMap:
    """Scan insertion into the tiled map — same rasterization as the dense
    path (raycast.scan_sample_cells, incl. area estimator and wall blur),
    scattered into the pool."""
    from . import raycast

    rows, cols, w_obs, s_obs = raycast.scan_sample_cells(
        bm.origin, bm.scale, pose, scan, cfg
    )
    return scatter_observations(bm, model, rows, cols, w_obs, s_obs)


def gather_window(
    table: Array,  # i32[TH, TW] slot per tile (-1 = init cell)
    pool: Array,  # f32[N, B, B, C]
    model,
    origin: Array,
    scale: float,
    center: Array,
    tiles_h: int,
    tiles_w: int,
) -> gridlib.GridMap:
    """Shared tile-window gather (used by the single-table BlockMap and by
    the CoW per-particle tables): densify the B-aligned ``tiles_h x
    tiles_w`` window around a world-space center into a GridMap."""
    n, b = pool.shape[0], pool.shape[1]
    th, tw = table.shape
    ct = gridlib.world_to_cell(
        gridlib.GridMap(cells=jnp.zeros((1, 1, 1)), origin=origin, scale=scale),
        center,
    )
    t0r = jnp.clip(ct[..., 0] // b - tiles_h // 2, 0, max(th - tiles_h, 0))
    t0c = jnp.clip(ct[..., 1] // b - tiles_w // 2, 0, max(tw - tiles_w, 0))
    tr = t0r + jnp.arange(tiles_h)
    tc = t0c + jnp.arange(tiles_w)
    slots = table[tr[:, None], tc[None, :]]  # [tiles_h, tiles_w]
    blocks = jnp.where(
        (slots >= 0)[..., None, None, None],
        pool[jnp.clip(slots, 0, n - 1)],
        _model_init_cell(model),
    )  # [tiles_h, tiles_w, B, B, C]
    dense = blocks.transpose(0, 2, 1, 3, 4).reshape(
        tiles_h * b, tiles_w * b, -1
    )
    w_origin = origin + jnp.stack(
        [t0c.astype(jnp.float32), t0r.astype(jnp.float32)]
    ) * (b * scale)
    return gridlib.GridMap(cells=dense, origin=w_origin, scale=scale)


def extract_window(
    bm: BlockMap, model, center: Array, tiles_h: int, tiles_w: int
) -> gridlib.GridMap:
    """Gather the B-aligned window of ``tiles_h x tiles_w`` tiles around a
    world-space center into a dense GridMap for scoring/matching."""
    return gather_window(
        bm.table, bm.pool, model, bm.origin, bm.scale, center, tiles_h, tiles_w
    )


def occupancy_plane(bm: BlockMap, model) -> Array:
    """Full-extent dense occupancy readout (host/export path)."""
    gm = extract_window(
        bm, model, jnp.zeros(2), bm.table.shape[0], bm.table.shape[1]
    )
    return gridlib.occupancy_plane(gm, model)


def allocated_fraction(bm: BlockMap) -> Array:
    return bm.n_alloc.astype(jnp.float32) / bm.capacity
