"""Keyframe pose graph with loop closure and SE(2) Gauss-Newton solve.

This subsystem has NO direct counterpart in the reference master branch
(SURVEY.md §2.6: pose-graph/loop-closure is a required capability from
BASELINE.json configs[3], new in this build). Design:

- Fixed-capacity keyframe store (static shapes): poses, scans, and a chain
  of odometric edges; loop-closure edges appended into the same edge table.
- Loop detection re-uses the batched score kernel: a candidate old keyframe's
  scan is rendered into a small local map; the new scan is brute-force
  matched against it (coarse-to-fine window). All candidates are scored in
  one vmap dispatch with validity masks — no data-dependent control flow.
- The solver is Gauss-Newton on SE(2) relative-pose residuals
  ``e = [R(th_i)^T (t_j - t_i) - z_t, wrap(th_j - th_i - z_th)]`` with dense
  normal equations assembled by scatter-adding 3x3 blocks — a fixed-shape
  [3K, 3K] Cholesky solve on the device (K = keyframe capacity; unused DOFs are
  masked with identity rows). Gauge freedom is fixed by anchoring keyframe 0.
- ``schur_solve`` exposes block elimination (the Schur-complement reduction
  used by the distributed solver in parallel/dist_ba.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .. import struct
from ..ops import grid as gridlib
from ..ops import matchers as matcherslib
from ..ops import raycast, scoring
from ..ops.geometry import between, pose_distance, wrap_angle
from ..ops.scan import LaserScan

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    max_keyframes: int = 128
    max_edges: int = 512
    #: add a keyframe when the robot moved this far from the last one
    keyframe_distance: float = 0.5
    keyframe_angle_weight: float = 1.0
    #: loop closure: candidate keyframes within this radius, at least
    #: ``min_index_gap`` keyframes older, matched above ``min_prob``
    loop_radius: float = 2.0
    min_index_gap: int = 10
    min_prob: float = 0.65
    #: reject loop matches implying a pose correction larger than this
    #: (perceptual-aliasing gate: corridor-like environments produce
    #: high-scoring matches at wrong translations)
    max_loop_correction_xy: float = 1.5
    max_loop_correction_theta: float = 0.5
    #: max loop candidates scored per keyframe (batch width)
    max_candidates: int = 8
    #: local map rendered around an old keyframe for loop matching
    local_map_size: int = 96
    local_map_scale: float = 0.1
    #: render the candidate keyframe's scan plus +-submap_radius neighbor
    #: keyframes into the local map (submap matching: richer structure,
    #: better loop deltas than single-scan maps)
    submap_radius: int = 1
    #: matcher used to refine loop-closure relative poses: any key in
    #: ops.matchers.MATCHERS (SURVEY §2.6: loop proposals reuse the
    #: brute-force/M3RSM score kernels). The BF grid is the default: 7^3
    #: cells at beam stride 2 measured the SAME 2-lap ATE (0.0705) and
    #: loop count as the 9^3/stride-1 grid at ~4x less scoring work;
    #: raise the grid back — or switch to 'm3rsm' for a global
    #: branch-and-bound over larger windows — for harder datasets.
    #: NOTE (windowed M3RSM): M3RSMConfig.window > 0 requires the map dims
    #: to be divisible by 2**levels (m3rsm_match raises at trace time
    #: otherwise) — pick local_map_size aligned to the level count, or
    #: use window=0 full-plane scoring.
    loop_matcher_kind: str = "brute_force"
    loop_matcher: Any = matcherslib.BruteForceConfig(
        half_x=0.6, half_y=0.6, half_theta=0.3, n_x=7, n_y=7, n_theta=7,
        scoring=scoring.ScoringConfig(reducer="overlap", stride=2),
    )
    #: OPT-IN bounded parabolic sub-cell refinement of every loop match
    #: (per-axis parabola through the score at the argmax and its
    #: +-1-grid-step neighbors; displacement structurally <= half a step
    #: per axis). Default OFF — both refinement flavors were tried for
    #: the r5 "graph doubles tracker ATE" bug and REJECTED by
    #: measurement on the 2-lap bench (seed 42, quantization-error
    #: hypothesis refuted): unbounded hill-climb 0.464 (walks the
    #: corridor's degenerate score direction), bounded parabolic 0.316
    #: old weighting / 0.123 new weighting, vs 0.070 unrefined — the
    #: continuous score peak is BIASED at sub-cell level (the local map
    #: is rendered from estimated keyframe poses with wall-blur), so the
    #: integer argmax plus a correctly-calibrated information weight
    #: (huber_delta / loop_info_cap above) beats chasing the peak. Kept
    #: as a knob because coarser grids (pitch >> map noise) may invert
    #: the tradeoff on other datasets.
    loop_subcell_refine: bool = False
    #: information (inverse covariance) diagonals for the two edge types
    odom_info: tuple = (100.0, 100.0, 400.0)
    loop_info: tuple = (50.0, 50.0, 200.0)
    gn_iterations: int = 10
    gn_damping: float = 1e-4
    #: Huber robust kernel threshold on per-edge chi (sqrt of weighted
    #: squared residual) for LOOP edges; outlier loops get down-weighted
    #: instead of dragging the graph. <= 0 disables. Default 0.3 (r5):
    #: loop deltas from the BF grid carry up-to-half-a-pitch quantization
    #: error, so on sub-cell-accurate trajectories most loop residuals
    #: ARE "outliers" relative to the tracking chain — at delta 1.0 the
    #: kernel never engaged and the graph read 2x the tracker-only ATE on
    #: the 2-lap bench (0.141 vs 0.071 seed 42); 0.3 restores 0.0700
    #: while the large-drift scenario corrects identically (final error
    #: 0.068, peak 0.428 — IRLS re-weighting recovers as keyframes move).
    huber_delta: float = 0.3
    #: estimate loop-edge information from the match score curvature
    #: (degenerate directions — e.g. along a corridor — get low weight)
    #: instead of the fixed ``loop_info`` diagonal
    estimate_loop_info: bool = True
    #: clip range for the estimated information, as multiples of
    #: ``loop_info``: [0.1, loop_info_cap]. Score curvature measures match
    #: SHARPNESS, not match ERROR — a razor-sharp peak sitting half a BF
    #: grid step (0.1 m) from truth is still half a grid step off, so
    #: letting the estimate exceed the calibrated ``loop_info`` baseline
    #: makes the optimizer trust quantized deltas more than the tracking
    #: chain. On the 2-lap bench, cap 10.0 read 5-seed-class ATE 0.14 vs
    #: the same pipeline's 0.071 tracker; cap 1.0 restored parity while
    #: keeping the directional down-weighting.
    loop_info_cap: float = 1.0


@struct.dataclass
class PoseGraphState:
    kf_poses: Array  # f32[K, 3] current estimates
    kf_scans: LaserScan  # stacked [K, R]
    n_kf: Array  # i32[]
    edge_i: Array  # i32[E]
    edge_j: Array  # i32[E]
    edge_delta: Array  # f32[E, 3] measured j in i's frame
    edge_info: Array  # f32[E, 3] diagonal information
    edge_is_loop: Array  # bool[E] loop-closure edge (robust-kernel scope)
    n_edges: Array  # i32[]
    #: index of the last added keyframe (tracking chain tail)
    last_kf: Array  # i32[]
    #: sticky capacity flags (the blockmap overflow contract): set when an
    #: add_keyframe / edge append was DROPPED at capacity. Hosts poll these
    #: and grow() — silent saturation must never corrupt the graph.
    kf_overflow: Array = None  # bool[]
    edge_overflow: Array = None  # bool[]


def init_state(cfg: PoseGraphConfig, n_beams: int) -> PoseGraphState:
    k, e = cfg.max_keyframes, cfg.max_edges
    empty_scan = LaserScan(
        ranges=jnp.zeros((k, n_beams), jnp.float32),
        bearings=jnp.zeros((k, n_beams), jnp.float32),
        valid=jnp.zeros((k, n_beams), bool),
    )
    return PoseGraphState(
        kf_poses=jnp.zeros((k, 3), jnp.float32),
        kf_scans=empty_scan,
        n_kf=jnp.int32(0),
        edge_i=jnp.zeros((e,), jnp.int32),
        edge_j=jnp.zeros((e,), jnp.int32),
        edge_delta=jnp.zeros((e, 3), jnp.float32),
        edge_info=jnp.zeros((e, 3), jnp.float32),
        edge_is_loop=jnp.zeros((e,), bool),
        n_edges=jnp.int32(0),
        last_kf=jnp.int32(-1),
        kf_overflow=jnp.array(False),
        edge_overflow=jnp.array(False),
    )


def grow(
    cfg: PoseGraphConfig,
    st: PoseGraphState,
    max_keyframes: int | None = None,
    max_edges: int | None = None,
):
    """Host-side capacity growth event (the blockmap re-shard analogue):
    pad the keyframe/edge arrays to the new capacities, clear the overflow
    flags, and return ``(new_cfg, new_state)``. Capacities default to 2x.
    Jitted functions keyed on the old config retrace once afterwards —
    rare by design (capacity doubles), exactly like dense-map growth."""
    new_k = max_keyframes if max_keyframes is not None else 2 * cfg.max_keyframes
    new_e = max_edges if max_edges is not None else 2 * cfg.max_edges
    assert new_k >= cfg.max_keyframes and new_e >= cfg.max_edges

    def pad0(a, n):
        return jnp.concatenate(
            [a, jnp.zeros((n - a.shape[0], *a.shape[1:]), a.dtype)], axis=0
        )

    new_st = st.replace(
        kf_poses=pad0(st.kf_poses, new_k),
        kf_scans=jax.tree.map(lambda a: pad0(a, new_k), st.kf_scans),
        edge_i=pad0(st.edge_i, new_e),
        edge_j=pad0(st.edge_j, new_e),
        edge_delta=pad0(st.edge_delta, new_e),
        edge_info=pad0(st.edge_info, new_e),
        edge_is_loop=pad0(st.edge_is_loop, new_e),
        kf_overflow=jnp.array(False),
        edge_overflow=jnp.array(False),
    )
    new_cfg = dataclasses.replace(
        cfg, max_keyframes=new_k, max_edges=new_e
    )
    return new_cfg, new_st


def should_add_keyframe(cfg: PoseGraphConfig, st: PoseGraphState, pose: Array) -> Array:
    no_kf = st.n_kf == 0
    last = st.kf_poses[jnp.maximum(st.last_kf, 0)]
    far = pose_distance(last, pose, cfg.keyframe_angle_weight) > cfg.keyframe_distance
    return no_kf | far


def _append_edge(st: PoseGraphState, i, j, delta, info, is_loop=False) -> PoseGraphState:
    e = st.n_edges  # at capacity the write is dropped, not clipped onto e-1
    return st.replace(
        edge_i=st.edge_i.at[e].set(i, mode="drop"),
        edge_j=st.edge_j.at[e].set(j, mode="drop"),
        edge_delta=st.edge_delta.at[e].set(delta, mode="drop"),
        edge_info=st.edge_info.at[e].set(
            jnp.asarray(info, jnp.float32), mode="drop"
        ),
        edge_is_loop=st.edge_is_loop.at[e].set(is_loop, mode="drop"),
        n_edges=jnp.minimum(e + 1, st.edge_i.shape[0]),
        edge_overflow=st.edge_overflow | (e >= st.edge_i.shape[0]),
    )


def add_keyframe(
    cfg: PoseGraphConfig, st: PoseGraphState, pose: Array, scan: LaserScan
) -> PoseGraphState:
    """Unconditionally append a keyframe + odometric chain edge (callers gate
    with should_add_keyframe). Fixed shapes. At capacity the keyframe is
    DROPPED (never overwritten onto slot K-1, which would corrupt the graph)
    and ``kf_overflow`` latches so the host can :func:`grow` and re-add."""
    k = st.n_kf  # out of range when full -> mode='drop' skips the writes
    full = st.n_kf >= cfg.max_keyframes
    new = st.replace(
        kf_poses=st.kf_poses.at[k].set(pose, mode="drop"),
        kf_scans=jax.tree.map(
            lambda buf, s: buf.at[k].set(s, mode="drop"), st.kf_scans, scan
        ),
        n_kf=jnp.minimum(st.n_kf + 1, cfg.max_keyframes),
        kf_overflow=st.kf_overflow | full,
    )
    has_prev = (st.last_kf >= 0) & ~full
    prev = jnp.maximum(st.last_kf, 0)
    delta = between(st.kf_poses[prev], pose)
    new = jax.lax.cond(
        has_prev,
        lambda s: _append_edge(s, prev, k, delta, cfg.odom_info),
        lambda s: s,
        new,
    )
    return new.replace(last_kf=jnp.where(full, st.last_kf, k))


def process_keyframes(
    cfg: PoseGraphConfig,
    model,
    st: PoseGraphState,
    scans: LaserScan,  # stacked [B, R] (padded)
    poses: Array,  # f32[B, 3]
    valid: Array,  # bool[B] — padding mask
):
    """Add + loop-detect a BATCH of keyframes in one jitted dispatch.

    Every dispatched call costs host time whether or not the host waits,
    so the segmented full pipeline must not dispatch add/detect per
    keyframe.

    When the batch width B <= ``min_index_gap`` (and the submap radius is
    below the gap), detection across the batch is PROVABLY independent:
    keyframe b's candidate filter ``idx <= kf_idx_b - min_index_gap``
    excludes every same-batch keyframe, so all B detections read only
    pre-batch graph state. The batched path then runs every match of the
    batch in ONE vmap (B x max_candidates submap renders + grid scores in
    parallel; a serial lax.scan would leave the device idle B-1/B of the
    time) and replays the edge appends in
    sequential order, producing a bitwise-identical graph STRUCTURE
    (keyframe/edge indices, counts, order) as the sequential loop; edge
    values (delta/info) match to fp tolerance only — the batch-wide vmap
    changes reduction order (tests/test_posegraph.py asserts atol=1e-6 on
    deltas, rtol=0.1 on infos). Do not rely on bitwise edge values across
    the two paths.

    Wider batches (or configs whose gap is smaller than the batch) fall
    back to the sequential ``lax.scan`` — keyframe i's detection must see
    keyframes 0..i-gap, some of which are in the same batch.

    A keyframe DROPPED at capacity detects no loops in either path (the
    host grows the graph before saturation — full.FullSlamEngine).
    Returns ``(graph, total_new_loops)``.
    """
    b = poses.shape[0]
    if b <= cfg.min_index_gap and cfg.submap_radius < cfg.min_index_gap:
        return _process_keyframes_batched(cfg, model, st, scans, poses, valid)

    def body(g, inp):
        scan_i, pose_i, v = inp

        def do(g_):
            full = g_.n_kf >= cfg.max_keyframes
            g2 = add_keyframe(cfg, g_, pose_i, scan_i)
            return jax.lax.cond(
                full,
                lambda gg: (gg, jnp.int32(0)),
                lambda gg: detect_loops(cfg, model, gg, scan_i, pose_i),
                g2,
            )

        return jax.lax.cond(v, do, lambda g_: (g_, jnp.int32(0)), g)

    st, nls = jax.lax.scan(body, st, (scans, poses, valid))
    return st, nls.sum()


def _process_keyframes_batched(
    cfg: PoseGraphConfig,
    model,
    st: PoseGraphState,
    scans: LaserScan,
    poses: Array,
    valid: Array,
):
    """Batched process_keyframes (see its docstring for the exactness
    argument). Three passes: place keyframes (writes only) -> one vmapped
    detection over the whole batch (reads only) -> replay edge appends in
    the sequential order (writes only)."""

    # pass 1: place keyframes; record (index, placed, chain predecessor)
    def place_body(g, inp):
        scan_i, pose_i, v = inp
        full = g.n_kf >= cfg.max_keyframes
        place = v & ~full
        k = g.n_kf
        # out-of-range index when not placing -> mode='drop' skips writes
        kw = jnp.where(place, k, cfg.max_keyframes)
        new = g.replace(
            kf_poses=g.kf_poses.at[kw].set(pose_i, mode="drop"),
            kf_scans=jax.tree.map(
                lambda buf, s: buf.at[kw].set(s, mode="drop"), g.kf_scans,
                scan_i,
            ),
            n_kf=jnp.where(place, jnp.minimum(g.n_kf + 1, cfg.max_keyframes),
                           g.n_kf),
            kf_overflow=g.kf_overflow | (v & full),
            last_kf=jnp.where(place, k, g.last_kf),
        )
        return new, (k, place, g.last_kf)

    st2, (kf_idx, placed, prevs) = jax.lax.scan(
        place_body, st, (scans, poses, valid)
    )

    # pass 2: ALL detections of the batch in one vmap against the placed
    # state (exact: candidates are all strictly older than the batch)
    cand, accept, poses_m, infos = jax.vmap(
        lambda s_b, p_b, k_b: _detect_candidates(cfg, model, st2, s_b, p_b, k_b)
    )(scans, poses, kf_idx)

    # pass 3: replay edge appends in sequential order (odom edge then loop
    # edges per keyframe), so the edge table is bitwise the sequential one
    def replay_body(g, inp):
        k_b, place_b, prev_b, pose_b, cand_b, acc_b, pm_b, inf_b = inp

        def do(g_):
            def with_odom(s):
                delta = between(s.kf_poses[jnp.maximum(prev_b, 0)], pose_b)
                return _append_edge(s, prev_b, k_b, delta, cfg.odom_info)

            g_ = jax.lax.cond(prev_b >= 0, with_odom, lambda s: s, g_)
            return _append_loop_edges(cfg, g_, k_b, cand_b, acc_b, pm_b, inf_b)

        g = jax.lax.cond(place_b, do, lambda g_: g_, g)
        return g, jnp.where(place_b, acc_b.sum(), 0)

    st3, nls = jax.lax.scan(
        replay_body, st2,
        (kf_idx, placed, prevs, poses, cand, accept, poses_m, infos),
    )
    return st3, nls.sum()


# --- loop closure -----------------------------------------------------------


def _render_local_map(
    cfg: PoseGraphConfig, model, st: PoseGraphState, ci: Array
):
    """Submap around keyframe ``ci``: its scan plus +-submap_radius
    neighbors inserted at their current pose estimates.

    For additive-fold cell models (``fold_additive`` — BayesAvg) the
    neighbor scans rasterize IN PARALLEL (vmap over observation planes,
    one fold) instead of a serial insert chain: exactly the same map up
    to fp summation order, and the parallel shape keeps the device busy
    (the serial chain was a per-keyframe latency tax inside the
    loop-detection hot path)."""
    n = cfg.local_map_size
    center = st.kf_poses[ci]
    gm = gridlib.GridMap(
        cells=gridlib.make_grid_map(model, n, n, cfg.local_map_scale).cells,
        origin=center[:2] - n * cfg.local_map_scale / 2.0,
        scale=cfg.local_map_scale,
    )
    beam = raycast.BeamConfig(wall_blur=True)
    span = 2 * cfg.submap_radius + 1

    def neighbor_scan(k):
        idx = ci + k - cfg.submap_radius
        ok = (idx >= 0) & (idx < st.n_kf)
        idx_c = jnp.clip(idx, 0, cfg.max_keyframes - 1)
        kf_scan = jax.tree.map(lambda a: a[idx_c], st.kf_scans)
        kf_scan = kf_scan.replace(valid=kf_scan.valid & ok)
        return kf_scan, st.kf_poses[idx_c]

    if getattr(model, "fold_additive", False):
        def planes_one(k):
            kf_scan, pose = neighbor_scan(k)
            return raycast.scan_observation_planes(gm, pose, kf_scan, beam)

        w_all, s_all = jax.vmap(planes_one)(jnp.arange(span))
        return gridlib.apply_observations(gm, model, w_all.sum(0), s_all.sum(0))

    def insert_one(k, g):
        kf_scan, pose = neighbor_scan(k)
        return raycast.insert_scan(g, model, pose, kf_scan, beam)

    return jax.lax.fori_loop(0, span, insert_one, gm)


def _match_loop(cfg: PoseGraphConfig, view, scan, pose):
    """Shared loop-closure match (detect_loops + densify_loops): the
    configured matcher, then the sub-cell hill-climb polish, then the
    information estimate AT THE REFINED POSE.

    The refinement is a per-axis parabolic peak fit through the score at
    the matched pose and its +-1-grid-step neighbors (sub-pixel peak
    interpolation) — bounded by construction to half a step per axis,
    which is exactly the quantization error it exists to remove (see
    PoseGraphConfig.loop_subcell_refine for the measured negative result
    that rules out unbounded descent here)."""
    _, loop_match_fn = matcherslib.MATCHERS[cfg.loop_matcher_kind]
    res = loop_match_fn(view, scan, pose, None, cfg.loop_matcher)
    if cfg.loop_subcell_refine:
        lm = cfg.loop_matcher
        # grid pitches; non-grid matchers fall back to one cell / 0.05 rad
        sx = 2.0 * getattr(lm, "half_x", 0.0) / max(
            getattr(lm, "n_x", 1) - 1, 1) or cfg.local_map_scale
        sy = 2.0 * getattr(lm, "half_y", 0.0) / max(
            getattr(lm, "n_y", 1) - 1, 1) or cfg.local_map_scale
        st_ = 2.0 * getattr(lm, "half_theta", 0.0) / max(
            getattr(lm, "n_theta", 1) - 1, 1) or 0.05
        offs = jnp.array(
            [
                [0.0, 0.0, 0.0],
                [-sx, 0.0, 0.0], [sx, 0.0, 0.0],
                [0.0, -sy, 0.0], [0.0, sy, 0.0],
                [0.0, 0.0, -st_], [0.0, 0.0, st_],
            ],
            jnp.float32,
        )
        probs7 = scoring.score_poses(
            view, scan, res.pose[None, :] + offs, lm.scoring
        )

        def peak(sm, s0, sp, step):
            denom = sm + sp - 2.0 * s0
            t = 0.5 * (sm - sp) / jnp.where(
                jnp.abs(denom) < 1e-12, jnp.inf, denom)
            # move only toward a concave peak; flat/convex stays put
            return jnp.where(
                denom < 0, jnp.clip(t, -0.5, 0.5) * step, 0.0)

        d = jnp.stack([
            peak(probs7[1], probs7[0], probs7[2], sx),
            peak(probs7[3], probs7[0], probs7[4], sy),
            peak(probs7[5], probs7[0], probs7[6], st_),
        ])
        res = matcherslib.MatchResult(
            pose=res.pose + d, prob=res.prob, trace=res.trace)
    if cfg.estimate_loop_info:
        info = scoring.estimate_information(
            view, scan, res.pose, cfg.loop_matcher.scoring
        )
        base = jnp.asarray(cfg.loop_info, jnp.float32)
        info = jnp.clip(info, 0.1 * base, cfg.loop_info_cap * base)
    else:
        info = jnp.asarray(cfg.loop_info, jnp.float32)
    return res.pose, res.prob, info


def _detect_candidates(
    cfg: PoseGraphConfig, model, st: PoseGraphState, scan: LaserScan,
    pose: Array, kf_idx: Array,
):
    """Pure compute half of :func:`detect_loops`: pick candidates, match,
    gate — NO state writes. Returns ``(cand, accept, poses_m, infos)``.

    Reads only keyframe poses/scans with index <= kf_idx - min_index_gap
    (all strictly older than ``kf_idx``), which is what makes batching
    detection across a keyframe batch exact (process_keyframes)."""
    idxs = jnp.arange(cfg.max_keyframes)
    dist = jnp.linalg.norm(st.kf_poses[:, :2] - pose[None, :2], axis=-1)
    ok = (
        (idxs < st.n_kf)
        & (idxs <= kf_idx - cfg.min_index_gap)
        & (dist < cfg.loop_radius)
    )
    # take the closest max_candidates candidates
    order = jnp.argsort(jnp.where(ok, dist, jnp.inf))
    cand = order[: cfg.max_candidates]
    cand_ok = ok[cand]

    def match_cand(ci):
        gm = _render_local_map(cfg, model, st, ci)
        view = scoring.MapView.of(gm, model)
        return _match_loop(cfg, view, scan, pose)

    poses_m, probs, infos = jax.vmap(match_cand)(cand)
    # perceptual-aliasing gate: the matched pose must stay near the current
    # estimate — high-score matches at wrong translations are rejected
    corr = poses_m - pose[None, :]
    corr_ok = (
        (jnp.linalg.norm(corr[:, :2], axis=-1) <= cfg.max_loop_correction_xy)
        & (jnp.abs(wrap_angle(corr[:, 2])) <= cfg.max_loop_correction_theta)
    )
    accept = cand_ok & (probs > cfg.min_prob) & corr_ok
    return cand, accept, poses_m, infos


def _append_loop_edges(
    cfg: PoseGraphConfig, st: PoseGraphState, kf_idx, cand, accept,
    poses_m, infos,
) -> PoseGraphState:
    def add_one(i, s):
        def do(s):
            delta = between(s.kf_poses[cand[i]], poses_m[i])
            return _append_edge(s, cand[i], kf_idx, delta, infos[i],
                                is_loop=True)

        return jax.lax.cond(accept[i], do, lambda s: s, s)

    return jax.lax.fori_loop(0, cfg.max_candidates, add_one, st)


def detect_loops(
    cfg: PoseGraphConfig, model, st: PoseGraphState, scan: LaserScan, pose: Array
) -> PoseGraphState:
    """Match the newest keyframe's scan against up to ``max_candidates`` old
    keyframes; append accepted constraints. One vmap dispatch, masked."""
    kf_idx = st.last_kf
    cand, accept, poses_m, infos = _detect_candidates(
        cfg, model, st, scan, pose, kf_idx
    )
    st = _append_loop_edges(cfg, st, kf_idx, cand, accept, poses_m, infos)
    return st, accept.sum()


def densify_loops(
    cfg: PoseGraphConfig, model, st: PoseGraphState
) -> tuple[PoseGraphState, Array]:
    """Propose loop closures over ALL keyframe pairs, not just the newest.

    ``detect_loops`` only matches the tracking tail, so a trajectory that
    closes one big loop gets endpoint constraints while mid-loop keyframes
    keep their accumulated drift (DESIGN.md §7). This pass runs at optimize
    rate: for every keyframe j, find its nearest index-distant keyframe i,
    drop pairs already constrained by a loop edge, take the
    ``max_candidates`` closest pairs, and score them with the same batched
    submap brute-force match + aliasing gates as ``detect_loops``. Fixed
    shapes throughout (one [K, K] distance matrix, masked argsort, one vmap
    dispatch)."""
    kmax = cfg.max_keyframes
    idxs = jnp.arange(kmax)
    xy = st.kf_poses[:, :2]
    dist = jnp.linalg.norm(xy[None, :, :] - xy[:, None, :], axis=-1)  # [i, j]
    in_use = idxs < st.n_kf
    pair_ok = (
        in_use[:, None]
        & in_use[None, :]
        & (idxs[:, None] <= idxs[None, :] - cfg.min_index_gap)
        & (dist < cfg.loop_radius)
    )
    # drop pairs already constrained by a loop edge (either direction)
    e_active = jnp.arange(st.edge_i.shape[0]) < st.n_edges
    has_edge = jnp.zeros((kmax, kmax), bool)
    ei = jnp.where(e_active & st.edge_is_loop, st.edge_i, kmax)
    ej = jnp.where(e_active & st.edge_is_loop, st.edge_j, kmax)
    has_edge = has_edge.at[ei, ej].set(True, mode="drop")
    has_edge = has_edge.at[ej, ei].set(True, mode="drop")
    pair_ok = pair_ok & ~has_edge

    # one candidate i per j (the closest), then the closest max_candidates js
    best_i = jnp.argmin(jnp.where(pair_ok, dist, jnp.inf), axis=0)  # [K]
    j_ok = pair_ok[best_i, idxs]
    j_dist = dist[best_i, idxs]
    order = jnp.argsort(jnp.where(j_ok, j_dist, jnp.inf))
    cand_j = order[: cfg.max_candidates]
    cand_i = best_i[cand_j]
    cand_ok = j_ok[cand_j]

    def match_pair(ci, cj):
        gm = _render_local_map(cfg, model, st, ci)
        view = scoring.MapView.of(gm, model)
        pose_j = st.kf_poses[cj]
        scan_j = jax.tree.map(lambda a: a[cj], st.kf_scans)
        return _match_loop(cfg, view, scan_j, pose_j)

    poses_m, probs, infos = jax.vmap(match_pair)(cand_i, cand_j)
    corr = poses_m - st.kf_poses[cand_j]
    corr_ok = (
        (jnp.linalg.norm(corr[:, :2], axis=-1) <= cfg.max_loop_correction_xy)
        & (jnp.abs(wrap_angle(corr[:, 2])) <= cfg.max_loop_correction_theta)
    )
    accept = cand_ok & (probs > cfg.min_prob) & corr_ok

    def add_one(k, s):
        def do(s):
            delta = between(s.kf_poses[cand_i[k]], poses_m[k])
            return _append_edge(
                s, cand_i[k], cand_j[k], delta, infos[k], is_loop=True
            )

        return jax.lax.cond(accept[k], do, lambda s: s, s)

    return jax.lax.fori_loop(0, cfg.max_candidates, add_one, st), accept.sum()


# --- Gauss-Newton solve -----------------------------------------------------


def _mm(a: Array, b: Array) -> Array:
    """f32 matrix product pinned to full precision: the backend default
    (TF32 on GPUs) keeps ~10 mantissa bits, too few for GN normal
    equations."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _edge_residual_jac(pi: Array, pj: Array, z: Array):
    """Residual (3,) and Jacobians (3,3),(3,3) wrt pose i and j."""
    c, s = jnp.cos(pi[2]), jnp.sin(pi[2])
    rt = jnp.array([[c, s], [-s, c]])  # R(th_i)^T
    dt = pj[:2] - pi[:2]
    et = _mm(rt, dt) - z[:2]
    eth = wrap_angle(pj[2] - pi[2] - z[2])
    e = jnp.concatenate([et, eth[None]])
    drt = jnp.array([[-s, c], [-c, -s]])  # d(R^T)/dth
    ji = jnp.zeros((3, 3)).at[:2, :2].set(-rt).at[:2, 2].set(_mm(drt, dt)).at[2, 2].set(-1.0)
    jj = jnp.zeros((3, 3)).at[:2, :2].set(rt).at[2, 2].set(1.0)
    return e, ji, jj


def optimize(cfg: PoseGraphConfig, st: PoseGraphState) -> PoseGraphState:
    """Batched Gauss-Newton over all edges; dense [3K, 3K] normal equations.

    Unused keyframe DOFs and keyframe 0 (gauge anchor) get identity rows.
    """
    kmax = cfg.max_keyframes
    n_dof = 3 * kmax
    e_idx = jnp.arange(st.edge_i.shape[0])
    e_mask = (e_idx < st.n_edges).astype(jnp.float32)

    def gn_iter(_, poses):
        def per_edge(i, j, z, info, m, is_loop):
            e, ji, jj = _edge_residual_jac(poses[i], poses[j], z)
            w = info * m  # (3,) diagonal information, masked
            if cfg.huber_delta > 0:
                # Huber robust kernel on LOOP edges: w *= min(1, delta/chi)
                chi = jnp.sqrt(jnp.maximum((w * e * e).sum(), 1e-12))
                rw = jnp.minimum(1.0, cfg.huber_delta / chi)
                w = w * jnp.where(is_loop, rw, 1.0)
            hii = _mm(ji.T * w, ji)
            hij = _mm(ji.T * w, jj)
            hjj = _mm(jj.T * w, jj)
            bi = _mm(ji.T, w * e)
            bj = _mm(jj.T, w * e)
            return hii, hij, hjj, bi, bj

        hii, hij, hjj, bi, bj = jax.vmap(per_edge)(
            st.edge_i, st.edge_j, st.edge_delta, st.edge_info, e_mask,
            st.edge_is_loop,
        )
        h = jnp.zeros((n_dof, n_dof))
        b = jnp.zeros((n_dof,))
        r3 = jnp.arange(3)
        ri = (3 * st.edge_i)[:, None] + r3[None, :]  # (E, 3)
        rj = (3 * st.edge_j)[:, None] + r3[None, :]

        def blocks(h, rows, cols, vals):
            return h.at[rows[:, :, None], cols[:, None, :]].add(vals)

        h = blocks(h, ri, ri, hii)
        h = blocks(h, ri, rj, hij)
        h = blocks(h, rj, ri, jnp.swapaxes(hij, 1, 2))
        h = blocks(h, rj, rj, hjj)
        b = b.at[ri].add(bi).at[rj].add(bj)

        # mask: unused keyframes + gauge anchor (kf 0) -> identity row, 0 rhs
        kf_used = (jnp.arange(kmax) < st.n_kf) & (jnp.arange(kmax) > 0)
        dof_used = jnp.repeat(kf_used, 3)
        h = jnp.where(dof_used[:, None] & dof_used[None, :], h, 0.0)
        h = h + jnp.diag(jnp.where(dof_used, cfg.gn_damping, 1.0))
        b = jnp.where(dof_used, b, 0.0)

        # H is SPD (JtWJ + damping; identity rows for masked DOFs) —
        # Cholesky + two triangular solves, no pivoting needed
        l = jnp.linalg.cholesky(h)
        dx = jax.scipy.linalg.cho_solve((l, True), -b).reshape(kmax, 3)
        new = poses + dx
        return new.at[:, 2].set(wrap_angle(new[:, 2]))

    poses = jax.lax.fori_loop(0, cfg.gn_iterations, gn_iter, st.kf_poses)
    return st.replace(kf_poses=poses)


def graph_error(st: PoseGraphState) -> Array:
    """Total weighted squared residual over active edges (diagnostic)."""
    e_mask = (jnp.arange(st.edge_i.shape[0]) < st.n_edges).astype(jnp.float32)

    def per_edge(i, j, z, info, m):
        e, _, _ = _edge_residual_jac(st.kf_poses[i], st.kf_poses[j], z)
        return (info * e * e).sum() * m

    return jax.vmap(per_edge)(
        st.edge_i, st.edge_j, st.edge_delta, st.edge_info, e_mask
    ).sum()


def schur_solve(h: Array, b: Array, split: int) -> Array:
    """Solve H x = b by Schur-complement elimination of the trailing block.

    ``split`` is static: H = [[A, B], [B^T, C]] with A = h[:s, :s].
    The reduced system (A - B C^-1 B^T) x1 = b1 - B C^-1 b2 is solved first —
    this is the reduction parallel/dist_ba.py distributes over hosts.
    """
    a = h[:split, :split]
    bb = h[:split, split:]
    c = h[split:, split:]
    b1, b2 = b[:split], b[split:]
    c_inv_bt = jnp.linalg.solve(c, bb.T)
    c_inv_b2 = jnp.linalg.solve(c, b2)
    s = a - _mm(bb, c_inv_bt)
    x1 = jnp.linalg.solve(s, b1 - _mm(bb, c_inv_b2))
    x2 = c_inv_b2 - _mm(c_inv_bt, x1)
    return jnp.concatenate([x1, x2])


def joint_refine(
    cfg: PoseGraphConfig,
    model,
    st: PoseGraphState,
    gm_template: gridlib.GridMap,
    beam: raycast.BeamConfig,
    rounds: int = 4,
    damping: float = 0.5,
    matcher: str = "brute_force",
    matcher_cfg=None,
) -> PoseGraphState:
    """Joint pose/map refinement by damped leave-one-out alternation
    (Occupancy-SLAM-flavored, arXiv:2405.10743 — idea only: optimize poses
    against the occupancy map they jointly build).

    Per round, every keyframe pose is re-matched against the map built from
    ALL OTHER keyframes and moved ``damping`` of the way to its match:

    - **Leave-one-out is exact and costs one rasterization pass**: cell
      models fold commutative (weight, weighted-occupancy) totals, so the
      map without scan i is the closed-form fold of
      ``(W_total - W_i, S_total - S_i)``. Matching a scan against a map
      containing itself (the naive alternation) plateaus — measured: the
      self-term anchors each pose to its own error.
    - **Damping is what makes alternation converge**: undamped simultaneous
      re-matching improves one round then diverges (poses chase the moving
      consensus; measured 0.128 -> 0.082 -> ... -> 0.128 m). With
      lambda=0.5 (Jacobi relaxation) the same problem converges
      0.128 -> 0.049 m and stays there.

    The anchor keyframe 0 is fixed (gauge). Use after loop closure to
    crispen the map: GN optimizes the graph from pairwise constraints;
    this polishes every pose against the dense occupancy consensus."""
    from ..ops import matchers as matcherslib

    cfg_cls, match_fn = matcherslib.MATCHERS[matcher]
    if matcher_cfg is None:
        if matcher == "brute_force":
            matcher_cfg = matcherslib.BruteForceConfig(
                half_x=0.35, half_y=0.35, half_theta=0.12,
                n_x=15, n_y=15, n_theta=9,
                scoring=scoring.ScoringConfig(reducer="overlap"),
            )
        else:
            matcher_cfg = cfg_cls()
    kmax = cfg.max_keyframes

    def one_round(_, poses):
        def planes_one(i):
            scan = jax.tree.map(lambda a: a[i], st.kf_scans)
            scan = scan.replace(valid=scan.valid & (i < st.n_kf))
            return raycast.scan_observation_planes(
                gm_template, poses[i], scan, beam
            )

        w_all, s_all = jax.vmap(planes_one)(jnp.arange(kmax))  # [K, H, W]
        w_tot, s_tot = w_all.sum(0), s_all.sum(0)

        def refine_one(i):
            gm = gridlib.apply_observations(
                gm_template, model, w_tot - w_all[i], s_tot - s_all[i]
            )
            view = scoring.MapView.of(gm, model)
            scan = jax.tree.map(lambda a: a[i], st.kf_scans)
            res = match_fn(view, scan, poses[i], None, matcher_cfg)
            d = res.pose - poses[i]
            d = d.at[2].set(wrap_angle(d[2]))
            new = poses[i] + damping * d
            new = new.at[2].set(wrap_angle(new[2]))
            ok = (i > 0) & (i < st.n_kf)  # keep anchor + unused rows
            return jnp.where(ok, new, poses[i])

        return jax.vmap(refine_one)(jnp.arange(kmax))

    poses = jax.lax.fori_loop(0, rounds, one_round, st.kf_poses)
    return st.replace(kf_poses=poses)


def regenerate_map(
    cfg: PoseGraphConfig, model, st: PoseGraphState, gm: gridlib.GridMap,
    beam: raycast.BeamConfig,
    group: int = 8,
) -> gridlib.GridMap:
    """Rebuild a map by inserting every stored keyframe scan at its
    optimized pose (the post-loop-closure map regeneration pass).

    Additive-fold cell models (BayesAvg) rasterize keyframes in PARALLEL:
    observation planes for ``group`` keyframes at a time (vmap; the group
    bounds the transient one-hot rasterization buffers), partial-summed
    under ``lax.map``, one cell fold at the end — same map as the serial
    insert chain up to fp summation order, at a fraction of the serial
    latency (round-4: regeneration ran after every closure burst and the
    K-long serial chain was a dominant full-pipeline cost). Order-
    sensitive models (TBM, exp-smoothing) keep the sequential fold."""

    if getattr(model, "fold_additive", False):
        kmax = cfg.max_keyframes
        g = min(group, kmax)
        n_groups = -(-kmax // g)
        idx_groups = jnp.arange(n_groups * g).reshape(n_groups, g)

        def planes_one(i):
            i_c = jnp.minimum(i, kmax - 1)
            scan = jax.tree.map(lambda a: a[i_c], st.kf_scans)
            scan = scan.replace(valid=scan.valid & (i < st.n_kf))
            return raycast.scan_observation_planes(
                gm, st.kf_poses[i_c], scan, beam
            )

        def group_fn(idxs):
            w, s = jax.vmap(planes_one)(idxs)
            return w.sum(0), s.sum(0)

        w_g, s_g = jax.lax.map(group_fn, idx_groups)
        return gridlib.apply_observations(gm, model, w_g.sum(0), s_g.sum(0))

    def body(i, g):
        scan = jax.tree.map(lambda a: a[i], st.kf_scans)
        scan = scan.replace(valid=scan.valid & (i < st.n_kf))
        return raycast.insert_scan(g, model, st.kf_poses[i], scan, beam)

    return jax.lax.fori_loop(0, cfg.max_keyframes, body, gm)
