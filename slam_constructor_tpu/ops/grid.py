"""Occupancy grid maps as dense array state.

Parity with the reference's map layer (SURVEY.md §2.3:
``RegularSquaresGrid``, ``GridMap``, ``PlainGridMap``,
``UnboundedPlainGridMap`` in ``src/core/maps/*.h`` [unverified]) —
re-architected for XLA: the map is a pytree holding one dense
``f32[H, W, C]`` belief tensor (channels defined by the cell model, plus a
trailing observation-weight channel), with an array ``origin`` so host-side
"growth" events (the unbounded-map capability) never change traced shapes.

Index convention: cell index ``[row, col]`` with ``row ~ y`` and ``col ~ x``;
``origin`` is the world coordinate of the lower-left corner of cell (0, 0).

The tiled/block-pool storage (reference ``LazyTiledGridMap``) and the
multi-resolution pyramid (``RescalableCachingGridMap``) live in
``blockmap.py`` and ``m3rsm.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import struct

Array = jax.Array

#: channel index of the accumulated observation weight (cells never observed
#: have weight 0 — the "unknown cell" predicate of the reference's GridCell).
WEIGHT_CHANNEL = -1
_RES_EPS = 1e-9


@struct.dataclass
class GridMap:
    cells: Array  # f32[H, W, C]: model belief channels + weight channel
    origin: Array  # f32[2]: world (x, y) of lower-left corner of cell (0,0)
    scale: float = struct.field(pytree_node=False)  # meters per cell

    @property
    def height(self) -> int:
        return self.cells.shape[0]

    @property
    def width(self) -> int:
        return self.cells.shape[1]

    @property
    def belief(self) -> Array:
        return self.cells[..., :-1]

    @property
    def weight(self) -> Array:
        return self.cells[..., WEIGHT_CHANNEL]


def make_grid_map(
    model,
    height: int,
    width: int,
    scale: float,
    origin: tuple[float, float] | None = None,
) -> GridMap:
    """Create an empty map. Default origin centers the map on world (0, 0)
    (matches the reference's centered default extent)."""
    if origin is None:
        origin = (-width * scale / 2.0, -height * scale / 2.0)
    belief = jnp.broadcast_to(
        jnp.asarray(model.init_belief(), jnp.float32), (height, width, model.n_channels)
    )
    weight = jnp.zeros((height, width, 1), jnp.float32)
    cells = jnp.concatenate([belief, weight], axis=-1)
    return GridMap(
        cells=cells, origin=jnp.asarray(origin, jnp.float32), scale=float(scale)
    )


def world_to_cell(gm: GridMap, pts: Array) -> Array:
    """World points ``f32[..., 2]`` -> int32 cell indices ``[..., 2]`` as
    (row, col). May be out of bounds — pair with :func:`in_bounds`."""
    rel = (pts - gm.origin) / gm.scale
    col = jnp.floor(rel[..., 0]).astype(jnp.int32)
    row = jnp.floor(rel[..., 1]).astype(jnp.int32)
    return jnp.stack([row, col], axis=-1)


def cell_center(gm: GridMap, idx: Array) -> Array:
    """Cell indices ``[..., 2]`` (row, col) -> world centers ``f32[..., 2]``."""
    x = gm.origin[0] + (idx[..., 1].astype(jnp.float32) + 0.5) * gm.scale
    y = gm.origin[1] + (idx[..., 0].astype(jnp.float32) + 0.5) * gm.scale
    return jnp.stack([x, y], axis=-1)


def in_bounds(gm: GridMap, idx: Array) -> Array:
    return (
        (idx[..., 0] >= 0)
        & (idx[..., 0] < gm.height)
        & (idx[..., 1] >= 0)
        & (idx[..., 1] < gm.width)
    )


def clip_index(gm: GridMap, idx: Array) -> Array:
    return jnp.stack(
        [
            jnp.clip(idx[..., 0], 0, gm.height - 1),
            jnp.clip(idx[..., 1], 0, gm.width - 1),
        ],
        axis=-1,
    )


def gather_plane(plane: Array, idx: Array, oob_value: float, h: int, w: int) -> Array:
    """Gather ``plane[idx]`` with out-of-bounds indices mapped to
    ``oob_value``. ``plane`` is f32[H, W]; ``idx`` int32[..., 2] (row, col)."""
    ok = (
        (idx[..., 0] >= 0) & (idx[..., 0] < h) & (idx[..., 1] >= 0) & (idx[..., 1] < w)
    )
    r = jnp.clip(idx[..., 0], 0, h - 1)
    c = jnp.clip(idx[..., 1], 0, w - 1)
    return jnp.where(ok, plane[r, c], oob_value)


def apply_observations(gm: GridMap, model, w_obs: Array, s_obs: Array) -> GridMap:
    """Fold accumulated per-cell observations into the map.

    ``w_obs`` f32[H, W]: total observation weight added to each cell this
    step; ``s_obs`` f32[H, W]: weight-summed observed occupancy values.
    This is the array-wide, commutative equivalent of the reference's
    per-cell virtual ``GridCell::operator+=(AreaOccupancyObservation)``
    (SURVEY.md §2.3) — the scatter happens upstream in ``raycast.insert``;
    here the chosen cell model applies its closed-form k-fold update.
    """
    n_prev = gm.weight
    belief = model.update(gm.belief, n_prev, w_obs, s_obs)
    cells = jnp.concatenate([belief, (n_prev + w_obs)[..., None]], axis=-1)
    return gm.replace(cells=cells)


def occupancy_plane(gm: GridMap, model) -> Array:
    """f32[H, W] occupancy-probability readout under the cell model."""
    return model.occupancy(gm.belief)


def known_mask(gm: GridMap) -> Array:
    return gm.weight > 0.0


# --- host-side growth (unbounded-map capability) ---------------------------


def grow_to_contain(
    gm: GridMap, model, pts: np.ndarray, margin_cells: int = 16
) -> GridMap:
    """Host-side re-shard event replacing the reference's
    ``UnboundedPlainGridMap`` auto-expansion: returns a map whose extent
    covers ``pts`` (numpy ``[N, 2]`` world points), copying existing content.
    Never call under jit — shapes change. No-op if already contained."""
    origin = np.asarray(gm.origin)
    h, wdt, c = gm.cells.shape
    col = np.floor((pts[:, 0] - origin[0]) / gm.scale).astype(np.int64)
    row = np.floor((pts[:, 1] - origin[1]) / gm.scale).astype(np.int64)
    if (row >= 0).all() and (row < h).all() and (col >= 0).all() and (col < wdt).all():
        return gm  # contained — no growth (margin only pads actual growth)
    lo_r = min(0, int(row.min()) - margin_cells)
    lo_c = min(0, int(col.min()) - margin_cells)
    hi_r = max(h, int(row.max()) + 1 + margin_cells)
    hi_c = max(wdt, int(col.max()) + 1 + margin_cells)
    empty = np.concatenate(
        [np.asarray(model.init_belief(), np.float32), np.zeros((1,), np.float32)]
    )
    new = np.broadcast_to(empty, (hi_r - lo_r, hi_c - lo_c, c)).copy()
    new[-lo_r : -lo_r + h, -lo_c : -lo_c + wdt] = np.asarray(gm.cells)
    new_origin = origin + np.array([lo_c, lo_r], np.float64) * gm.scale
    return GridMap(
        cells=jnp.asarray(new),
        origin=jnp.asarray(new_origin, jnp.float32),
        scale=gm.scale,
    )


def rescale(gm: GridMap, model, factor: int) -> GridMap:
    """Change the map resolution by an integer factor (the reference's
    ``GridMap`` rescaling hooks / RescalableCachingGridMap scale changes —
    SURVEY.md §2.3; ``src/core/maps/grid_map.h`` [unverified]).

    ``factor > 0``: COARSEN — each new cell aggregates a ``factor x factor``
    block: observation weights ADD (total evidence is conserved) and belief
    channels combine by evidence-weighted mean (cells with no evidence
    contribute nothing; an all-unknown block keeps the model's init belief).
    ``factor < 0``: REFINE by ``k = -factor`` — each cell splits into
    ``k x k`` children carrying the parent belief with weight ``w / k^2``
    (evidence conserved, occupancy field unchanged).

    World geometry is preserved exactly: origin is unchanged and
    ``scale' = scale * factor`` (or ``/ k``), so a world point falls in the
    aggregated/refined cell covering the same area. Coarsening requires the
    extent to divide by ``factor``. Pure and jit-safe (static factor).
    """
    h, w, c = gm.cells.shape
    if factor == 0:
        raise ValueError("rescale factor must be a nonzero integer")
    if factor == 1 or factor == -1:
        return gm
    if factor > 0:
        k = factor
        if h % k or w % k:
            raise ValueError(f"extent {h}x{w} not divisible by factor {k}")
        blocks = gm.cells.reshape(h // k, k, w // k, k, c)
        wgt = blocks[..., -1]  # [H', k, W', k]
        wsum = wgt.sum(axis=(1, 3))  # [H', W']
        bel = (blocks[..., :-1] * wgt[..., None]).sum(axis=(1, 3)) / jnp.maximum(
            wsum, _RES_EPS
        )[..., None]
        init = jnp.asarray(model.init_belief(), jnp.float32)
        bel = jnp.where((wsum > 0)[..., None], bel, init)
        cells = jnp.concatenate([bel, wsum[..., None]], axis=-1)
        return gm.replace(cells=cells, scale=gm.scale * k)
    k = -factor
    cells = jnp.repeat(jnp.repeat(gm.cells, k, axis=0), k, axis=1)
    cells = cells.at[..., -1].mul(1.0 / (k * k))
    return gm.replace(cells=cells, scale=gm.scale / k)
