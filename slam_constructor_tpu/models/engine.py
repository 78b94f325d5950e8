"""The SLAM engine: the reference's ``World`` layer as a pure step function.

Parity targets (SURVEY.md §2.2, §3.2 [unverified paths]):
- ``World<ObservationT, MapT>::handle_sensor_data`` +
  ``LaserScanGridWorld`` (``src/core/states/world.h``,
  ``laser_scan_grid_world.h``): per-scan control flow =
  scan-match(prior ⊕ odometry) -> update pose -> insert scan into map.

Re-design: the reference is an OOP event loop driven by ROS callbacks, one
virtual dispatch per component per scan. Here a *single-hypothesis* SLAM
algorithm is one jitted pure function ``step(state, obs) -> state`` over a
``SlamState`` pytree, with every component (cell model, matcher, scan adder)
chosen at trace time from static config. Whole sequences run device-resident
under ``lax.scan`` (``run_sequence``) so host<->device traffic is one
transfer per *sequence*, not per scan — the pipeline-parallel answer to the
reference's strictly serial per-scan loop.

The GMapping-style particle-filter world builds on the same pieces in
``gmapping.py``; the pose-graph backend is ``posegraph.py``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from .. import struct
from ..ops import cells as cellslib
from ..ops import grid as gridlib
from ..ops import matchers as matcherslib
from ..ops import raycast, scoring
from ..ops.geometry import apply_pose, compose
from ..ops.scan import LaserScan


def apply_pose_np(pose, pts, valid):
    """Valid world-frame scan endpoints (host-side helper for map growth)."""
    import numpy as np

    world = np.asarray(apply_pose(pose, pts))
    return world[np.asarray(valid)]

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static, hashable configuration tree (the reference's
    PropertiesProvider-selected component wiring — SURVEY.md §2.8)."""

    cell_model: Any = cellslib.BayesAvgCell()
    matcher: str = "monte_carlo"  # key into ops.matchers.MATCHERS
    matcher_cfg: Any = matcherslib.MonteCarloConfig()
    beam: raycast.BeamConfig = raycast.BeamConfig()
    map_height: int = 256
    map_width: int = 256
    map_scale: float = 0.1
    #: skip map insertion when match probability is below this (vinySLAM's
    #: quality gating; 0.0 = always insert like tinySLAM)
    min_insert_prob: float = 0.0
    #: optional second matcher run from the primary result (e.g. 'gradient'
    #: or 'hill_climbing' sub-cell refinement after the Monte-Carlo search)
    refine_matcher: Any = None  # key into ops.matchers.MATCHERS
    refine_cfg: Any = None
    #: weight beams by scan-degeneracy angle histogram (vinySLAM feature)
    use_angle_histogram: bool = False
    #: dense-path matching window (cells, 0 = score against the whole
    #: map). One robot-centered window per match (the sanctioned slice
    #: form — CLAUDE.md); EXACT when the window covers the scan's usable
    #: reach from any candidate: window/2 >= beam.max_range/scale +
    #: search extent. Shrinks the planes every score call reads.
    match_window: int = 0
    #: 'dense' (PlainGridMap-style) or 'tiled' (block-pool LazyTiledGridMap)
    map_storage: str = "dense"
    #: tiled storage: block edge (cells), pool capacity (blocks), and the
    #: dense scoring window around the robot (tiles per side)
    tile_block: int = 32
    tile_capacity: int = 512
    window_tiles: int = 10


@struct.dataclass
class SlamState:
    """Single-hypothesis engine state — one pytree, checkpointable as-is."""

    gm: gridlib.GridMap
    pose: Array  # f32[3]
    key: Array
    step: Array  # i32[]
    last_prob: Array  # f32[]
    #: live max-occupancy pyramid for the M3RSM matcher (the reference's
    #: RescalableCachingGridMap keeps its coarse caches current on every
    #: write — SURVEY.md §2.3); empty tuple when the matcher doesn't use one
    pyramid: tuple = struct.field(default_factory=tuple)


def _uses_pyramid(cfg: EngineConfig) -> bool:
    return cfg.matcher == "m3rsm" and cfg.map_storage == "dense"


def _refresh_pyramid(cfg: EngineConfig, gm, pose: Array, pyramid: tuple) -> tuple:
    """Re-pool the pyramid region a scan insert from ``pose`` can touch.

    Incremental (O(footprint^2)) when map dims are 2^levels-aligned and the
    footprint is smaller than the map; otherwise a full rebuild (same cost
    as before the cache existed, never worse)."""
    from ..ops import m3rsm as m3rsmlib

    mcfg = cfg.matcher_cfg
    levels = mcfg.levels
    unknown = mcfg.scoring.unknown_prob
    view = scoring.MapView.of(gm, cfg.cell_model)
    h, w = view.occ.shape
    step = 1 << levels
    # the insert's reach: usable range, PLUS the wall-blur tail that writes
    # occupancy up to hole_width/2 beyond the endpoint (raycast.py) — missing
    # it left blur cells outside the refreshed window for blur configs
    reach = cfg.beam.max_range + cfg.beam.hole_width / 2.0
    bbox = 2 * int(-(-reach // cfg.map_scale)) + 4
    size = m3rsmlib.pyramid_refresh_size(bbox, levels, min(h, w))
    if h % step or w % step or size >= min(h, w):
        return m3rsmlib.build_pyramid(view, levels, unknown)
    center = gridlib.world_to_cell(gm, pose[None, :2])[0]
    return m3rsmlib.update_pyramid(pyramid, view, unknown, center, size)


def init_state(cfg: EngineConfig, key: Array | None = None) -> SlamState:
    if key is None:
        key = jax.random.PRNGKey(0)
    if cfg.map_storage == "tiled":
        from ..ops import blockmap

        gm = blockmap.make_block_map(
            cfg.cell_model,
            tiles_h=cfg.map_height // cfg.tile_block,
            tiles_w=cfg.map_width // cfg.tile_block,
            capacity=cfg.tile_capacity,
            block=cfg.tile_block,
            scale=cfg.map_scale,
        )
    else:
        gm = gridlib.make_grid_map(
            cfg.cell_model, cfg.map_height, cfg.map_width, cfg.map_scale
        )
    pyramid: tuple = ()
    if _uses_pyramid(cfg):
        from ..ops import m3rsm as m3rsmlib

        pyramid = m3rsmlib.build_pyramid(
            scoring.MapView.of(gm, cfg.cell_model),
            cfg.matcher_cfg.levels,
            cfg.matcher_cfg.scoring.unknown_prob,
        )
    return SlamState(
        gm=gm,
        pose=jnp.zeros(3, jnp.float32),
        key=key,
        step=jnp.int32(0),
        last_prob=jnp.float32(0.0),
        pyramid=pyramid,
    )


def _point_weights(cfg: EngineConfig, scan: LaserScan) -> Array | None:
    if not cfg.use_angle_histogram:
        return None
    # vinySLAM-style degeneracy weighting: scan points lying on
    # over-represented wall directions (long straight walls) are
    # down-weighted. A point's direction is its local wall TANGENT — the
    # direction of the consecutive-endpoint difference — not its bearing.
    from ..ops.scan import angle_histogram, scan_points

    hist = angle_histogram(scan)
    n_bins = hist.shape[0]
    pts = scan_points(scan)
    d = pts[1:] - pts[:-1]
    tangent = jnp.arctan2(d[..., 1], d[..., 0])  # [R-1]
    tangent = jnp.concatenate([tangent, tangent[-1:]])  # [R]
    bins = jnp.clip(
        jnp.floor((tangent + jnp.pi) / (2 * jnp.pi) * n_bins), 0, n_bins - 1
    ).astype(jnp.int32)
    # hist is normalized; hist*n_bins == 1 for a uniform direction spread
    w = 1.0 / (1.0 + hist[bins] * n_bins)
    return w.astype(jnp.float32)


def _refine(cfg: EngineConfig, view, scan, res, key, pw):
    """Optional second matcher pass from the primary matcher's pose.

    Both local refiners (hill-climbing, gradient) are monotone — they keep
    the start pose unless the score improves — so composition never hurts
    the match probability."""
    if cfg.refine_matcher is None:
        return res
    refine_cfg, refine_fn = matcherslib.MATCHERS[cfg.refine_matcher]
    rcfg = cfg.refine_cfg if cfg.refine_cfg is not None else refine_cfg()
    return refine_fn(view, scan, res.pose, key, rcfg, pw)


def slam_step(
    cfg: EngineConfig, state: SlamState, scan: LaserScan, odom_delta: Array,
    quality: Array | float = 1.0,
) -> SlamState:
    """One scan: match then map (reference hot path, SURVEY.md §3.2).

    ``quality`` scales this scan's observation weight (the reference's
    TransformedLaserScan quality: low-confidence scans update the map
    weakly without being dropped).
    """
    _, match_fn = matcherslib.MATCHERS[cfg.matcher]
    prior = compose(state.pose, odom_delta)
    key, sub = jax.random.split(state.key)
    pw = _point_weights(cfg, scan)

    if cfg.map_storage == "tiled":
        from ..ops import blockmap

        window = blockmap.extract_window(
            state.gm, cfg.cell_model, prior[:2], cfg.window_tiles, cfg.window_tiles
        )
        view = scoring.MapView.of(window, cfg.cell_model)
        res = match_fn(view, scan, prior, sub, cfg.matcher_cfg, pw)
        res = _refine(cfg, view, scan, res, sub, pw)
        do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
        # TransformedLaserScan-quality parity with the dense branch: the
        # observation weights are scaled by q (q = 0 when gated — zero-weight
        # samples allocate no tiles and the cell fold no-ops on them)
        q = jnp.where(do_insert, jnp.asarray(quality, jnp.float32), 0.0)
        rows, cols, w_obs, s_obs = raycast.scan_sample_cells(
            state.gm.origin, state.gm.scale, res.pose, scan, cfg.beam
        )
        gm = blockmap.scatter_observations(
            state.gm, cfg.cell_model, rows, cols, q * w_obs, q * s_obs
        )
    else:
        view = scoring.MapView.of(state.gm, cfg.cell_model)
        if cfg.match_window and not _uses_pyramid(cfg):
            # single prior-centered window per match (m3rsm handles its
            # own windowing against the cached pyramid — see M3RSMConfig)
            view = scoring.window_view(view, prior[:2], cfg.match_window)
        if _uses_pyramid(cfg) and state.pyramid:
            # live RescalableCachingGridMap cache: no per-match rebuild
            res = match_fn(
                view, scan, prior, sub, cfg.matcher_cfg, pw,
                pyramid=state.pyramid,
            )
        else:
            res = match_fn(view, scan, prior, sub, cfg.matcher_cfg, pw)
        res = _refine(cfg, view, scan, res, sub, pw)
        w_obs, s_obs = raycast.scan_observation_planes(
            state.gm, res.pose, scan, cfg.beam
        )
        do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
        q = jnp.where(do_insert, jnp.asarray(quality, jnp.float32), 0.0)
        gm = gridlib.apply_observations(
            state.gm, cfg.cell_model, q * w_obs, q * s_obs
        )
    pyramid = state.pyramid
    if _uses_pyramid(cfg) and pyramid:
        # refresh only when the insert actually changed cells (q == 0 on
        # gated scans leaves the map untouched; re-pooling would be wasted)
        pyramid = jax.lax.cond(
            q > 0,
            lambda g, pyr: _refresh_pyramid(cfg, g, res.pose, pyr),
            lambda g, pyr: pyr,
            gm, pyramid,
        )
    return SlamState(
        gm=gm, pose=res.pose, key=key, step=state.step + 1, last_prob=res.prob,
        pyramid=pyramid,
    )


@partial(jax.jit, static_argnums=0, donate_argnums=1)
def run_sequence(
    cfg: EngineConfig, state: SlamState, scans: LaserScan, odom: Array
):
    """Device-resident run over a whole scan sequence.

    ``scans`` is a batched LaserScan pytree ``[T, R]``; ``odom`` is
    ``f32[T, 3]``. Returns (final_state, trajectory f32[T, 3], probs f32[T]).
    """

    def body(st, inp):
        scan, od = inp
        st = slam_step(cfg, st, scan, od)
        return st, (st.pose, st.last_prob)

    state, (traj, probs) = jax.lax.scan(body, state, (scans, odom))
    return state, traj, probs


class Engine:
    """Host-side driver (the reference's node main + ros::spin replacement):
    owns config + compiled step, feeds scans, exposes map/trajectory."""

    def __init__(self, cfg: EngineConfig, key: Array | None = None):
        self.cfg = cfg
        self.state = init_state(cfg, key)
        self._step = jax.jit(partial(slam_step, cfg))
        self.trajectory: list = []

    def handle_scan(
        self, scan: LaserScan, odom_delta: Array, quality: float = 1.0
    ) -> Array:
        """Online mode: one scan at a time (ROS-callback equivalent)."""
        if self.auto_grow and self.cfg.map_storage == "dense":
            self._maybe_grow(scan)
        self.state = self._step(self.state, scan, odom_delta, quality)
        self.trajectory.append(self.state.pose)
        return self.state.pose

    #: grow the dense map when the scan's reach leaves the current extent
    #: (the UnboundedPlainGridMap capability as a host-side re-shard event;
    #: triggers an XLA recompile, so growth adds a margin to stay rare)
    auto_grow: bool = False

    def _maybe_grow(self, scan: LaserScan) -> None:
        import numpy as np

        from ..ops.scan import scan_points

        pts = np.asarray(
            apply_pose_np(self.state.pose, scan_points(scan), scan.valid)
        )
        if pts.size == 0:
            return
        gm = gridlib.grow_to_contain(self.state.gm, self.cfg.cell_model, pts)
        pyramid = self.state.pyramid
        if pyramid and gm.cells.shape != self.state.gm.cells.shape:
            # growth changed the map extent: the cached pyramid is stale in
            # shape — rebuild it (rare host-side event, like the regrow)
            from ..ops import m3rsm as m3rsmlib

            pyramid = m3rsmlib.build_pyramid(
                scoring.MapView.of(gm, self.cfg.cell_model),
                self.cfg.matcher_cfg.levels,
                self.cfg.matcher_cfg.scoring.unknown_prob,
            )
        self.state = self.state.replace(gm=gm, pyramid=pyramid)

    def run(self, scans: LaserScan, odom: Array):
        """Offline mode: whole sequence in one device dispatch."""
        self.state, traj, probs = run_sequence(self.cfg, self.state, scans, odom)
        self.trajectory.extend(list(traj))
        return traj, probs

    def run_stream(self, items) -> None:
        """Streaming mode with double-buffered prefetch (the PP axis of
        SURVEY.md §2.9): the NEXT (scan, odom) pair is transferred to the
        device while the current step executes — JAX's async dispatch
        overlaps host IO, transfer, and compute with no extra threads.

        ``items`` yields (LaserScan, odom_delta) pairs (host or device).
        """
        pending = None
        for item in items:
            item_dev = jax.device_put(item)  # async H2D for the NEXT step
            if pending is not None:
                self.state = self._step(self.state, *pending)
                self.trajectory.append(self.state.pose)
            pending = item_dev
        if pending is not None:
            self.state = self._step(self.state, *pending)
            self.trajectory.append(self.state.pose)

    @property
    def occupancy(self) -> Array:
        if self.cfg.map_storage == "tiled":
            from ..ops import blockmap

            return blockmap.occupancy_plane(self.state.gm, self.cfg.cell_model)
        return gridlib.occupancy_plane(self.state.gm, self.cfg.cell_model)

    @property
    def pose(self) -> Array:
        return self.state.pose
