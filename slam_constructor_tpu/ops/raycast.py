"""Batched ray casting: scan insertion into grid maps and synthetic scan
generation.

Parity targets (SURVEY.md §2.3, §2.8 [unverified paths]):
- ``GridRasterizedRectangle`` / Bresenham beam traversal
  (``src/core/maps/grid_rasterization.h``)  -> fixed-step DDA sampling with
  consecutive-duplicate-cell masking (static shapes; no data-dependent loops).
- ``CellOccupancyEstimator`` (const / area)
  (``src/core/maps/cell_occupancy_estimator.h``, ``area_occupancy_estimator.h``)
  -> closed-form endpoint-square/cell overlap areas over a 3x3 window.
- scan adder incl. tinySLAM's wall-blur "hole width" trick
  (``src/core/maps/grid_map_scan_adder.h``) -> extra samples along the ray
  tail with ramped occupancy.
- ``LaserScanGenerator`` (``src/utils/data_generation/laser_scan_generator.h``)
  -> ``cast_rays``: dense ray marching against an occupancy plane; this is the
  test oracle replacing datasets while offline.

Everything is one fused jit region per scan: sample positions -> cell
indices -> masks -> flat scatter-add into (weight, occupancy-sum) planes ->
cell-model fold (see ``cells.py``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from . import grid as gridlib
from . import scan as scanlib
from .geometry import apply_pose

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Static knobs of the scan adder (reference: scan-adder + estimator
    construction in init_utils; SURVEY.md §2.7)."""

    max_range: float = 15.0
    #: DDA step as a fraction of the cell size for the free-space trace
    step_fraction: float = 0.5
    #: 'const' (hit cell only) or 'area' (endpoint square vs 3x3 cells)
    occupancy_estimator: str = "const"
    #: side of the endpoint square, in meters (tinySLAM "hole width");
    #: also the blur length when ``wall_blur`` is on
    hole_width: float = 0.3
    #: distribute occupied evidence along the ray tail (tinySLAM trick)
    wall_blur: bool = False
    #: number of blur samples along the tail when wall_blur is set
    blur_samples: int = 4
    #: 'auto' | 'scatter' | 'matmul': how observation samples accumulate
    #: into planes. 'auto' (= 'scatter') on every backend: XLA scatter-add
    #: for the free-space unit counts, and an order-independent sorted
    #: segment sum for the occupied evidence (fractional weights), so runs
    #: are bitwise repeatable. 'matmul' is an opt-in that rebuilds the
    #: plane as bf16 one-hot outer products (A^T @ diag(v) B; exact for
    #: unit counts, bf16-rounded fractional weights).
    scatter_impl: str = "auto"
    #: free-space ALGORITHM: 'dda' (per-beam line samples,
    #: reference-faithful Bresenham analogue) or 'polar' (dense per-cell
    #: polar fill: a cell is free iff it lies closer than the range of the
    #: beam covering its angle — an elementwise pass over the map; assumes
    #: uniformly spaced bearings, and its conservative neighbor-min range
    #: leaves an unknown halo at grazing walls, see DESIGN.md §16).
    #: Free-space only; endpoints keep their estimator.
    free_impl: str = "dda"

    def __post_init__(self):
        if self.free_impl not in ("dda", "polar"):
            raise ValueError(f"free_impl must name an algorithm, got {self.free_impl!r}")
        if self.scatter_impl not in ("auto", "scatter", "matmul"):
            raise ValueError(f"unknown scatter_impl {self.scatter_impl!r}")

    def n_free_samples(self, scale: float) -> int:
        return int(math.ceil(self.max_range / (scale * self.step_fraction))) + 1


_SCATTER_CHUNK = 16384


def _scatter_matmul(plane_shape, rows, cols, vals, valid):
    """Accumulate N point values into an [H, W] plane as sum_i
    onehot(r_i) ⊗ onehot(c_i) * v_i — two exact one-hot factors contracted
    as a matmul. bf16 one-hots are exact; accumulation is f32."""
    h, w = plane_shape
    rows = rows.ravel()
    cols = cols.ravel()
    v = jnp.where(valid, vals, 0.0).ravel().astype(jnp.float32)
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    v = jnp.where(ok.ravel(), v, 0.0)
    n = rows.shape[0]
    # contraction FLOPs are H*W*chunk per chunk regardless of occupancy —
    # small scatters (e.g. 360 endpoints) must not pad to the full chunk
    chunk = min(_SCATTER_CHUNK, max(512, ((n + 127) // 128) * 128))
    pad = (-n) % chunk
    if pad:
        rows = jnp.concatenate([rows, jnp.zeros((pad,), rows.dtype)])
        cols = jnp.concatenate([cols, jnp.zeros((pad,), cols.dtype)])
        v = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
    rows = rows.reshape(-1, chunk)
    cols = cols.reshape(-1, chunk)
    v = v.reshape(-1, chunk)

    def chunk(carry, inp):
        r, c, vv = inp
        a = (r[:, None] == jnp.arange(h)[None, :]).astype(jnp.bfloat16)  # [N, H]
        b = (c[:, None] == jnp.arange(w)[None, :]).astype(jnp.bfloat16)  # [N, W]
        bv = b * vv[:, None].astype(jnp.bfloat16)
        contrib = jax.lax.dot_general(
            a, bv, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )  # [H, W]
        return carry + contrib, None

    out, _ = jax.lax.scan(chunk, jnp.zeros((h, w), jnp.float32), (rows, cols, v))
    return out


def _scatter_matmul_multi(plane_shape, rows, cols, vals, valid):
    """``_scatter_matmul`` for V value channels at once: one dot_general
    producing ``f32[H, W, V]`` (one matmul pass + one one-hot construction
    replace V separate scatter dispatches).

    vals: f32[N, V]; valid: bool[N].
    """
    h, w = plane_shape
    rows = rows.ravel()
    cols = cols.ravel()
    n, v_n = vals.shape
    v = jnp.where(valid.ravel()[:, None], vals, 0.0).astype(jnp.float32)
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    v = jnp.where(ok[:, None], v, 0.0)
    chunk = min(_SCATTER_CHUNK, max(512, ((n + 127) // 128) * 128))
    pad = (-n) % chunk
    if pad:
        rows = jnp.concatenate([rows, jnp.zeros((pad,), rows.dtype)])
        cols = jnp.concatenate([cols, jnp.zeros((pad,), cols.dtype)])
        v = jnp.concatenate([v, jnp.zeros((pad, v_n), v.dtype)])
    rows = rows.reshape(-1, chunk)
    cols = cols.reshape(-1, chunk)
    v = v.reshape(-1, chunk, v_n)

    def body(carry, inp):
        r, c, vv = inp
        a = (r[:, None] == jnp.arange(h)[None, :]).astype(jnp.bfloat16)
        b = (c[:, None] == jnp.arange(w)[None, :]).astype(jnp.bfloat16)
        bv = (b[:, :, None] * vv[:, None, :].astype(jnp.bfloat16)).reshape(
            chunk, w * v_n
        )
        contrib = jax.lax.dot_general(
            a, bv, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )  # [H, W*V]
        return carry + contrib.reshape(h, w, v_n), None

    out, _ = jax.lax.scan(
        body, jnp.zeros((h, w, v_n), jnp.float32), (rows, cols, v)
    )
    return out


def _flat_scatter_add(plane_shape, rows, cols, vals, valid, impl: str = "auto"):
    """Scatter-add ``vals`` (any shape) into an ``f32[H, W]`` image.

    impl='scatter' / 'auto': XLA scatter-add with mode='drop' (used for the
    free-space counts: unit values sum exactly in any order).
    impl='matmul': one-hot contraction (bf16 value rounding on non-integer
    vals; counts of 1.0 are exact).
    """
    if impl == "matmul":
        return _scatter_matmul(plane_shape, rows, cols, vals, valid)
    h, w = plane_shape
    lin = rows * w + cols
    lin = jnp.where(valid & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w), lin, -1)
    flat = jnp.zeros((h * w,), jnp.float32)
    flat = flat.at[lin.ravel()].add(
        jnp.where(valid, vals, 0.0).ravel(), mode="drop"
    )
    return flat.reshape(h, w)


def _sorted_segment_add(plane_shape, rows, cols, vals, valid):
    """Scatter-add ``vals f32[N, V]`` into ``f32[H, W, V]`` with float sums
    that do not depend on execution order.

    XLA's GPU scatter-add accumulates with atomics, so non-integer values
    landing on one cell (endpoint hits plus wall-blur ramps) sum in a
    different order on every run. Here the samples are stably sorted by
    cell (each cell keeps its samples in arrival order), each cell's values
    are summed by a segmented scan (a fixed tree), and every cell is
    written once.
    """
    h, w = plane_shape
    rows, cols = rows.ravel(), cols.ravel()
    n = rows.shape[0]
    ok = valid.ravel() & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    lin = jnp.where(ok, rows * w + cols, h * w)  # h * w: dropped below
    vals = jnp.where(ok[:, None], vals, 0.0)
    order = jnp.argsort(lin, stable=True)
    lin, vals = lin[order], vals[order]
    new_cell = jnp.concatenate([jnp.ones((1,), bool), lin[1:] != lin[:-1]])

    def combine(a, b):
        (av, af), (bv, bf) = a, b
        return jnp.where(bf[..., None], bv, av + bv), af | bf

    sums, _ = jax.lax.associative_scan(combine, (vals, new_cell))
    last = jnp.concatenate([lin[1:] != lin[:-1], jnp.ones((1,), bool)])
    # each cell's last sample writes its sum (the dropped samples' segment
    # writes to h * w); every other sample gets its own index past h * w,
    # so the indices stay unique and all out-of-range ones are dropped
    dest = jnp.where(last, lin, h * w + 1 + jnp.arange(n, dtype=lin.dtype))
    flat = jnp.zeros((h * w, vals.shape[1]), jnp.float32)
    flat = flat.at[dest].set(sums, mode="drop", unique_indices=True)
    return flat.reshape(h, w, vals.shape[1])


def _endpoint_area_obs(gm, endpoints, valid, hole_width):
    """Area occupancy estimator: overlap of the ``hole_width`` square centered
    on each endpoint with the 3x3 cell neighborhood.

    Returns (rows, cols, weights, occ_values) each ``[R, 9]``; weight is the
    overlap area as a fraction of the cell area (the reference's
    AreaOccupancyEstimator quality), occupancy observed is 1.0.
    """
    scale = gm.scale
    idx = gridlib.world_to_cell(gm, endpoints)  # [R, 2] (row, col)
    offs = jnp.stack(
        jnp.meshgrid(jnp.arange(-1, 2), jnp.arange(-1, 2), indexing="ij"), axis=-1
    ).reshape(9, 2)
    nbr = idx[:, None, :] + offs[None, :, :]  # [R, 9, 2]
    cell_lo = nbr.astype(jnp.float32) * scale + gm.origin[::-1]  # (y, x) corners
    cell_lo = cell_lo[..., ::-1]  # -> (x, y)
    half = hole_width / 2.0
    e = endpoints[:, None, :]
    ov = jnp.clip(
        jnp.minimum(cell_lo + scale, e + half) - jnp.maximum(cell_lo, e - half), 0.0
    )
    area = ov[..., 0] * ov[..., 1] / (scale * scale)
    w = jnp.where(valid[:, None], area, 0.0)
    return nbr[..., 0], nbr[..., 1], w, jnp.ones_like(w)


def scan_sample_cells(origin, scale, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Rasterize one scan into flat observation samples (storage-agnostic).

    Returns (rows, cols, w, s) int32/f32 1-D arrays: free-space DDA samples
    (const estimator endpoints included) ready for any scatter backend —
    the dense planes, the block pool, or the CoW particle pool.
    """
    gm_like = gridlib.GridMap(cells=jnp.zeros((1, 1, 1)), origin=origin, scale=scale)
    angles = pose[2] + scan.bearings
    dirs = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)
    start = pose[:2]
    n_s = cfg.n_free_samples(scale)
    step = scale * cfg.step_fraction
    t = (jnp.arange(n_s, dtype=jnp.float32) + 0.5) * step
    pts = start + t[None, :, None] * dirs[:, None, :]
    idx = gridlib.world_to_cell(gm_like, pts)
    free_limit = scan.ranges - cfg.hole_width / 2.0
    valid = scan.valid[:, None] & (t[None, :] < free_limit[:, None])
    same = jnp.all(idx[:, 1:] == idx[:, :-1], axis=-1)
    first = jnp.ones((idx.shape[0], 1), bool)
    valid = valid & jnp.concatenate([first, ~same], axis=1)

    endpoints = start + scan.ranges[:, None] * dirs
    # usable-range cap on endpoint evidence (same rule as the dense path)
    ep_valid = scan.valid & (scan.ranges <= cfg.max_range)
    rows = [idx[..., 0].ravel()]
    cols = [idx[..., 1].ravel()]
    w = [jnp.where(valid, 1.0, 0.0).ravel()]
    s = [jnp.zeros(valid.size)]

    if cfg.occupancy_estimator == "area":
        r9, c9, wgt, occv = _endpoint_area_obs(
            gm_like, endpoints, ep_valid, cfg.hole_width
        )
        rows.append(r9.ravel())
        cols.append(c9.ravel())
        w.append(wgt.ravel())
        s.append((wgt * occv).ravel())
    else:
        eidx = gridlib.world_to_cell(gm_like, endpoints)
        rows.append(eidx[..., 0])
        cols.append(eidx[..., 1])
        w.append(ep_valid.astype(jnp.float32))
        s.append(ep_valid.astype(jnp.float32))

    if cfg.wall_blur:
        bt = jnp.linspace(-1.0, 1.0, cfg.blur_samples)
        tb = scan.ranges[:, None] + cfg.hole_width / 2.0 * bt[None, :]
        pb = start + tb[..., None] * dirs[:, None, :]
        ib = gridlib.world_to_cell(gm_like, pb)
        ramp = jnp.broadcast_to(1.0 - jnp.abs(bt)[None, :], tb.shape)
        vb = (ep_valid[:, None] & (tb > 0)).astype(jnp.float32)
        rows.append(ib[..., 0].ravel())
        cols.append(ib[..., 1].ravel())
        w.append((ramp * vb).ravel())
        s.append((ramp**2 * vb).ravel())

    return (
        jnp.concatenate(rows),
        jnp.concatenate(cols),
        jnp.concatenate(w),
        jnp.concatenate(s),
    )


def _polar_cells(h, w, origin, scale, pose, scan: scanlib.LaserScan):
    """Per-cell polar geometry of the map around ``pose``.

    Returns ``(d, bini, ok, wgt, rng_eff)``: distance from the pose, the
    index of the beam whose bearing covers the cell, whether that beam's
    sector contains the cell (FOV), the expected number of beams crossing
    the cell, and the per-beam conservative range.
    """
    from .geometry import wrap_angle

    r = scan.bearings.shape[0]
    ys = origin[1] + (jnp.arange(h, dtype=jnp.float32) + 0.5) * scale
    xs = origin[0] + (jnp.arange(w, dtype=jnp.float32) + 0.5) * scale
    dy = ys[:, None] - pose[1]  # [H, 1]
    dx = xs[None, :] - pose[0]  # [1, W]
    d = jnp.sqrt(dx * dx + dy * dy)  # [H, W]
    ang = jnp.arctan2(dy, dx) - pose[2]
    b0 = scan.bearings[0]
    db = (scan.bearings[-1] - b0) / jnp.maximum(r - 1, 1)
    db = jnp.where(jnp.abs(db) < 1e-6, 1.0, db)
    binf = wrap_angle(ang - b0) / db
    bini = jnp.round(binf).astype(jnp.int32)
    in_fov = (bini >= 0) & (bini <= r - 1)
    full_circle = jnp.abs(db) * r >= 2.0 * jnp.pi - 1.5 * jnp.abs(db)
    ok = in_fov | full_circle
    bini = jnp.where(full_circle, jnp.mod(bini, r), jnp.clip(bini, 0, r - 1))
    # conservative range per bin: min over the beam and its neighbors, so
    # free space never extends past an adjacent beam's hit (avoids eroding
    # walls seen at grazing angles through bin rounding). Invalid beams
    # contribute no free evidence themselves (0) but don't truncate their
    # neighbors' sectors (inf).
    rng_inf = jnp.where(scan.valid, scan.ranges, jnp.inf)
    prev_r = jnp.where(full_circle, jnp.roll(rng_inf, 1), jnp.concatenate([rng_inf[:1], rng_inf[:-1]]))
    next_r = jnp.where(full_circle, jnp.roll(rng_inf, -1), jnp.concatenate([rng_inf[1:], rng_inf[-1:]]))
    rng_eff = jnp.where(
        scan.valid, jnp.minimum(scan.ranges, jnp.minimum(prev_r, next_r)), 0.0
    )
    wgt = (
        2.0
        * jnp.arctan(scale / (2.0 * jnp.maximum(d, scale * 0.5)))
        / jnp.abs(db)
    )
    return d, bini, ok, wgt, rng_eff


def _polar_range_lookup(bini: Array, rng_eff: Array) -> Array:
    """``rng_eff[bini]`` as a chunked one-hot matvec at HIGHEST precision,
    which returns every range exactly (TF32 would cut a 15 m range by up
    to ~7 mm)."""
    r = rng_eff.shape[0]
    flat = bini.reshape(-1)
    n = flat.shape[0]
    chunk = min(8192, n)
    pad = (-n) % chunk
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
    iota_r = jnp.arange(r)

    def take(bc):
        oh = (bc[:, None] == iota_r[None, :]).astype(jnp.float32)
        return jnp.dot(
            oh, rng_eff, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    return jax.lax.map(take, flat.reshape(-1, chunk)).reshape(-1)[:n].reshape(bini.shape)


def _polar_free_plane(h, w, origin, scale, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Dense polar free-space weights (``free_impl='polar'``).

    For every cell: distance d and bearing from the pose; the cell is free
    iff ``d < range(nearest beam) - hole_width/2`` (and inside the FOV /
    max_range). The weight is the expected number of beams crossing the
    cell — ``2*atan(scale/2d) / beam_spacing`` — matching the DDA path's
    one-count-per-crossing-beam totals in expectation. Invalid beams
    contribute no free evidence (range -> 0), same as the DDA validity
    mask. Uniform bearing spacing assumed.
    """
    d, bini, ok, wgt, rng_eff = _polar_cells(h, w, origin, scale, pose, scan)
    cell_range = _polar_range_lookup(bini, rng_eff)
    free = ok & (d < cell_range - cfg.hole_width / 2.0) & (d < cfg.max_range)
    return jnp.where(free, wgt, 0.0)


def scan_observation_planes(gm, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Rasterize one scan from ``pose`` into observation planes.

    Returns ``(w_obs, s_obs)`` — per-cell observation weight and weighted
    occupancy sum — ready for :func:`grid.apply_observations`. Fuses the
    reference's per-beam hot loop #2 (SURVEY.md §3.2) into batched DDA.
    """
    h, w = gm.height, gm.width
    scale = gm.scale
    angles = pose[2] + scan.bearings  # [R]
    dirs = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)  # [R, 2]
    start = pose[:2]

    # --- free-space trace ---------------------------------------------------
    if cfg.free_impl == "polar":
        w_free = _polar_free_plane(h, w, gm.origin, scale, pose, scan, cfg)
    else:
        n_s = cfg.n_free_samples(scale)
        step = scale * cfg.step_fraction
        t = (jnp.arange(n_s, dtype=jnp.float32) + 0.5) * step  # [S]
        pts = start + t[None, :, None] * dirs[:, None, :]  # [R, S, 2]
        idx = gridlib.world_to_cell(gm, pts)  # [R, S, 2]
        free_limit = scan.ranges - cfg.hole_width / 2.0
        valid = scan.valid[:, None] & (t[None, :] < free_limit[:, None])
        # consecutive-duplicate-cell mask: each crossed cell counted once per beam
        same = jnp.all(idx[:, 1:] == idx[:, :-1], axis=-1)
        first = jnp.ones((idx.shape[0], 1), bool)
        valid = valid & jnp.concatenate([first, ~same], axis=1)
        w_free = _flat_scatter_add((h, w), idx[..., 0], idx[..., 1], jnp.ones(idx.shape[:2]), valid, cfg.scatter_impl)
        # free observations carry occupancy 0 -> contribute to w only

    # --- occupied evidence at endpoints -------------------------------------
    # beams longer than max_range carry no endpoint evidence (the scan
    # adder's usable-range cap, matching the free-space trace's reach — a
    # hit past the cap is as unobserved as no hit); this also bounds the
    # insert footprint to max_range, which the engine's incremental pyramid
    # refresh (models/engine.py::_refresh_pyramid) relies on
    ep_valid = scan.valid & (scan.ranges <= cfg.max_range)
    endpoints = start + scan.ranges[:, None] * dirs  # [R, 2]
    # collect every occupied-evidence sample (endpoint/area + blur tail)
    # into one flat batch: on the matmul path ONE fused dot_general then
    # accumulates BOTH planes (w, s) in a single pass
    occ_r, occ_c, occ_w, occ_s, occ_v = [], [], [], [], []
    if cfg.occupancy_estimator == "area":
        r9, c9, wgt, occ = _endpoint_area_obs(gm, endpoints, ep_valid, cfg.hole_width)
        occ_r.append(r9.ravel())
        occ_c.append(c9.ravel())
        occ_w.append(wgt.ravel())
        occ_s.append((wgt * occ).ravel())
        occ_v.append(wgt.ravel() > 0)
    else:
        eidx = gridlib.world_to_cell(gm, endpoints)
        ones = jnp.ones(eidx.shape[:1])
        occ_r.append(eidx[..., 0])
        occ_c.append(eidx[..., 1])
        occ_w.append(ones)
        occ_s.append(ones)  # occupancy 1.0 at hit cells
        occ_v.append(ep_valid)

    if cfg.wall_blur:
        # tinySLAM "hole" trick: triangular occupied evidence centered ON the
        # endpoint, extending hole_width/2 along the ray on BOTH sides — a
        # symmetric profile. (A one-sided ramp biases matching backward along
        # the beam: shifted-short endpoints would land in the ramp while
        # shifted-long ones fall into unknown space.)
        bt = jnp.linspace(-1.0, 1.0, cfg.blur_samples)  # [B] in hole units
        tb = scan.ranges[:, None] + cfg.hole_width / 2.0 * bt[None, :]
        pb = start + tb[..., None] * dirs[:, None, :]  # [R, B, 2]
        ib = gridlib.world_to_cell(gm, pb)
        occ_ramp = jnp.broadcast_to(1.0 - jnp.abs(bt)[None, :], tb.shape)
        vb = ep_valid[:, None] & (tb > 0)
        # weight AND observed occupancy both taper with the triangle, so the
        # map reads occupancy ~ramp at distance |d| from the wall center
        occ_r.append(ib[..., 0].ravel())
        occ_c.append(ib[..., 1].ravel())
        occ_w.append(occ_ramp.ravel())
        occ_s.append((occ_ramp**2).ravel())
        occ_v.append(vb.ravel())

    rows_a = jnp.concatenate(occ_r)
    cols_a = jnp.concatenate(occ_c)
    w_a = jnp.concatenate(occ_w)
    s_a = jnp.concatenate(occ_s)
    v_a = jnp.concatenate(occ_v)
    accumulate = (
        _scatter_matmul_multi if cfg.scatter_impl == "matmul" else _sorted_segment_add
    )
    planes = accumulate((h, w), rows_a, cols_a, jnp.stack([w_a, s_a], axis=-1), v_a)
    return w_free + planes[..., 0], planes[..., 1]


def insert_scan(gm, model, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Full scan insertion: rasterize + cell-model fold. Pure; jit-safe."""
    w_obs, s_obs = scan_observation_planes(gm, pose, scan, cfg)
    return gridlib.apply_observations(gm, model, w_obs, s_obs)


# --- synthetic scan generation (test/benchmark oracle) ----------------------


def cast_rays(
    occ_plane: Array,
    origin: Array,
    scale: float,
    pose: Array,
    bearings: Array,
    max_range: float = 15.0,
    threshold: float = 0.5,
    step_fraction: float = 0.25,
) -> scanlib.LaserScan:
    """Ray-march ``bearings`` from ``pose`` against a ground-truth occupancy
    plane; first sample with occupancy >= threshold is the hit.

    Replaces the reference's ``LaserScanGenerator`` test oracle. Out-of-map
    samples read as free. Beams that never hit are invalid.
    """
    h, w = occ_plane.shape
    step = scale * step_fraction
    n_s = int(math.ceil(max_range / step))
    t = (jnp.arange(n_s, dtype=jnp.float32) + 1.0) * step  # [S]
    angles = pose[2] + bearings
    dirs = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)  # [R, 2]
    pts = pose[:2] + t[None, :, None] * dirs[:, None, :]  # [R, S, 2]
    rel = (pts - origin) / scale
    col = jnp.floor(rel[..., 0]).astype(jnp.int32)
    row = jnp.floor(rel[..., 1]).astype(jnp.int32)
    vals = gridlib.gather_plane(occ_plane, jnp.stack([row, col], -1), 0.0, h, w)
    hit = vals >= threshold  # [R, S]
    any_hit = jnp.any(hit, axis=1)
    first = jnp.argmax(hit, axis=1)
    ranges = jnp.where(any_hit, t[first], max_range)
    return scanlib.LaserScan(
        ranges=ranges.astype(jnp.float32),
        bearings=jnp.asarray(bearings, jnp.float32),
        valid=any_hit,
    )
