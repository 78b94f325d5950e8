"""GMapping-style Rao-Blackwellized particle filter SLAM.

Parity targets (SURVEY.md §2.6, §3.4 [unverified]): the reference's
``src/slams/gmapping/`` re-implementation — P particles, each owning a pose
trajectory AND a private map; per-particle scan matching refines the
odometry proposal; weights multiply by scan likelihood; systematic
resampling when Neff drops (which in the reference deep-copies whole maps).

Re-design: the particle axis is a *batch* axis. Every per-particle step —
matching, weighting, map insertion — is one ``vmap`` dispatch over stacked
state ``(P, ...)``, so the device sees a ``[P*K, R, W]`` score gather instead
of a serial particle loop. Resampling gathers the stacked map tensor along
axis 0 (one device gather; the block-pool map upgrade makes this an index
copy). The particle axis is also the unit of multi-chip sharding
(parallel/particles.py shards it over the mesh with psum normalization).
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
from ..ops import raycast, resample, scoring
from ..ops.geometry import compose
from ..ops.scan import LaserScan

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class GMappingConfig:
    n_particles: int = 30
    cell_model: Any = cellslib.BayesAvgCell()
    matcher: str = "monte_carlo"
    matcher_cfg: Any = matcherslib.MonteCarloConfig(
        sigma_xy=0.08, sigma_theta=0.04, batch=16, rounds=6
    )
    beam: raycast.BeamConfig = raycast.BeamConfig()
    map_height: int = 256
    map_width: int = 256
    map_scale: float = 0.1
    #: odometry proposal noise (sampled per particle, the RBPF proposal):
    #: sigma = base + alpha * |odom component| (GMapping-style motion model
    #: — fast motion gets proportionally more proposal spread)
    noise_xy: float = 0.03
    noise_theta: float = 0.015
    alpha_xy: float = 0.1
    alpha_theta: float = 0.1
    #: resample when Neff < frac * P
    resample_threshold: float = 0.5
    #: sharpness of the weight update: logw += gamma * log(prob)
    weight_gamma: float = 8.0
    #: proposal distribution:
    #: 'odom'     — sample motion noise around the odometry prior, refine by
    #:              scan matching, weight by the matched probability (the
    #:              round-1 behavior; a plain bootstrap-ish RBPF).
    #: 'improved' — Grisetti et al.'s GMapping proposal: match from the
    #:              odometry prior, probe the score surface at
    #:              ``proposal_samples`` jittered points around the mode,
    #:              fit a Gaussian (mean + diagonal covariance) to
    #:              score^gamma x motion-prior, sample the new pose from it,
    #:              and weight by the MARGINAL likelihood (the tau-sum), not
    #:              the mode height — the part that makes 30 particles beat
    #:              one hypothesis under odometry noise.
    proposal: str = "odom"
    #: K probe points for the improved proposal's Gaussian fit
    proposal_samples: int = 16
    #: probe jitter around the matched mode (m / rad) — order of the map
    #: cell size, the scale the score surface is informative at
    proposal_radius_xy: float = 0.06
    proposal_radius_theta: float = 0.03
    #: 'dense' (per-particle dense maps, resample gathers map data) or
    #: 'cow' (shared block pool + per-particle tables, resample copies
    #: int32 tables only — the reference's expensive map deep-copy gone)
    map_storage: str = "dense"
    tile_block: int = 32
    tile_capacity: int = 1024
    window_tiles: int = 8
    #: dense-path matching window (cells, 0 = whole map). Matching work
    #: scales with window area, and candidates stay
    #: within beam reach of the prior — a window covering the scan
    #: footprint is exact (scoring.window_view) at a fraction of the cost.
    match_window: int = 0
    #: window extraction for matching: 'slice' (vmap(dynamic_slice) — P
    #: window gathers) or 'onehot' (batched one-hot matmul, bitwise-equal;
    #: see insert_impl)
    match_window_impl: str = "slice"
    #: dense-path insertion window (cells, 0 = whole map): rasterize + cell
    #: fold run on a dynamic slice around the particle pose instead of the
    #: full plane. Exact (bitwise vs full-plane insert) when the window
    #: covers the scan's usable reach: window/2 >= (max_range +
    #: hole_width)/scale + 2 — the GMapping maxUrange discipline.
    insert_window: int = 0
    #: how the insertion window is extracted/written back on the dense path:
    #: 'slice'  — vmap(dynamic_slice/dynamic_update_slice) with traced
    #:            offsets (P window copies).
    #: 'onehot' — separable one-hot f32 matmuls extract the window and
    #:            mask+scatter it back (the ops/scoring.py matmul sampling
    #:            pattern; exact — one-hot f32 matmuls at HIGHEST precision
    #:            are bitwise).
    insert_impl: str = "slice"
    #: optional second matcher pass per particle from the primary result
    #: (engine.EngineConfig.refine_matcher brought to the RBPF: both local
    #: refiners are monotone — keep-start-unless-better — so composition
    #: never hurts the match probability). Key into matchers.MATCHERS.
    #: CAUTION (measured, multiseed r3): refining EVERY particle onto the
    #: score mode collapses proposal diversity and degrades the filter
    #: (winner ATE 0.16 -> 1.44); useful for single-hypothesis work only.
    refine_matcher: Any = None
    refine_cfg: Any = None
    #: reference GMapping's ``minimumScore`` gate: when the matched score
    #: falls below this, distrust the matcher for that particle — keep its
    #: odometry-proposal pose and weight it by the score AT that pose
    #: (a failed match must not drag the particle; 0 disables)
    min_match_prob: float = 0.0

    def __post_init__(self):
        # a typo'd impl string would silently fall back to the slow 'slice'
        # path and quietly lose the measured speedup — fail loudly instead
        for field in ("match_window_impl", "insert_impl"):
            v = getattr(self, field)
            if v not in ("slice", "onehot"):
                raise ValueError(
                    f"{field}={v!r}: must be 'slice' or 'onehot'"
                )
        if self.map_storage not in ("dense", "cow"):
            raise ValueError(
                f"map_storage={self.map_storage!r}: must be 'dense' or 'cow'"
            )
        if self.proposal not in ("odom", "improved"):
            raise ValueError(
                f"proposal={self.proposal!r}: must be 'odom' or 'improved'"
            )


@struct.dataclass
class GMappingState:
    gm: gridlib.GridMap  # cells f32[P, H, W, C]; origin f32[P, 2]
    poses: Array  # f32[P, 3]
    log_weights: Array  # f32[P]
    key: Array
    step: Array  # i32[]


def init_state(cfg: GMappingConfig, key: Array | None = None) -> GMappingState:
    if key is None:
        key = jax.random.PRNGKey(0)
    p = cfg.n_particles
    if cfg.map_storage == "cow":
        from ..ops import cow

        gm = cow.make_cow_maps(
            cfg.cell_model,
            n_particles=p,
            tiles_h=cfg.map_height // cfg.tile_block,
            tiles_w=cfg.map_width // cfg.tile_block,
            capacity=cfg.tile_capacity,
            block=cfg.tile_block,
            scale=cfg.map_scale,
        )
        return GMappingState(
            gm=gm,
            poses=jnp.zeros((p, 3), jnp.float32),
            log_weights=jnp.full((p,), -jnp.log(float(p))),
            key=key,
            step=jnp.int32(0),
        )
    gm1 = gridlib.make_grid_map(
        cfg.cell_model, cfg.map_height, cfg.map_width, cfg.map_scale
    )
    gm = gridlib.GridMap(
        cells=jnp.broadcast_to(gm1.cells, (p, *gm1.cells.shape)),
        origin=jnp.broadcast_to(gm1.origin, (p, 2)),
        scale=gm1.scale,
    )
    return GMappingState(
        gm=gm,
        poses=jnp.zeros((p, 3), jnp.float32),
        log_weights=jnp.full((p,), -jnp.log(float(p))),
        key=key,
        step=jnp.int32(0),
    )


def _improved_proposal(view, scan, matched, prior_p, sigma, key, cfg):
    """Grisetti-style improved proposal for one particle.

    Probes the scan-likelihood surface at ``proposal_samples`` jittered
    points around the matched mode, weights each by score^gamma x the
    motion-model prior (tau), fits mean + diagonal covariance, samples the
    new pose from that Gaussian, and returns the MARGINAL log-likelihood
    (log mean tau) as the particle's weight increment — the reference
    GMapping weighting, replacing mode-height weighting (SURVEY.md §3.4).
    """
    from ..ops import scoring as scoringlib
    from ..ops.geometry import wrap_angle

    j = cfg.proposal_samples
    kj, ks = jax.random.split(key)
    rad = jnp.array(
        [cfg.proposal_radius_xy, cfg.proposal_radius_xy, cfg.proposal_radius_theta]
    )
    deltas = jax.random.normal(kj, (j, 3)) * rad
    cand = jnp.concatenate(
        [matched.pose[None, :2] + deltas[:, :2],
         wrap_angle(matched.pose[None, 2:] + deltas[:, 2:])], axis=-1
    )
    probs = scoringlib.score_poses(view, scan, cand, cfg.matcher_cfg.scoring)
    d = cand - prior_p[None, :]
    d = d.at[:, 2].set(wrap_angle(d[:, 2]))
    # sigma is a BODY-frame spread (the motion noise is composed in the
    # robot frame); rotate the world-frame probe deltas into the prior's
    # body frame before applying the axis-aligned Gaussian
    ch, sh = jnp.cos(prior_p[2]), jnp.sin(prior_p[2])
    d_body = jnp.stack(
        [ch * d[:, 0] + sh * d[:, 1], -sh * d[:, 0] + ch * d[:, 1], d[:, 2]],
        axis=-1,
    )
    log_motion = -0.5 * ((d_body / jnp.maximum(sigma, 1e-4)) ** 2).sum(-1)
    logtau = cfg.weight_gamma * jnp.log(probs + 1e-6) + log_motion
    lse = jax.scipy.special.logsumexp(logtau)
    wj = jnp.exp(logtau - lse)  # [J], sums to 1
    # moments in mode-relative coordinates (angle deltas stay small)
    dm = cand - matched.pose[None, :]
    dm = dm.at[:, 2].set(wrap_angle(dm[:, 2]))
    mu = (wj[:, None] * dm).sum(0)
    var = (wj[:, None] * (dm - mu[None, :]) ** 2).sum(0)
    # floor: quarter of the probe radius, so a peaked surface still keeps
    # enough diversity to survive resampling
    var = var + (0.25 * rad) ** 2
    pose = matched.pose + mu + jax.random.normal(ks, (3,)) * jnp.sqrt(var)
    pose = pose.at[2].set(wrap_angle(pose[2]))
    return pose, lse - jnp.log(float(j))


def _gate_match(cfg: GMappingConfig, view, scan, res, prior_p):
    """Reference GMapping's minimumScore: a match scoring below the gate is
    distrusted — the particle keeps its odometry-proposal pose, weighted by
    the score at THAT pose (one extra score eval, gate-rate independent)."""
    if cfg.min_match_prob <= 0:
        return res
    p_prior = scoring.score_poses(
        view, scan, prior_p[None], cfg.matcher_cfg.scoring
    )[0]
    use = res.prob >= cfg.min_match_prob
    return res.replace(
        pose=jnp.where(use, res.pose, prior_p),
        prob=jnp.where(use, res.prob, p_prior),
    )


def _refine_rbpf(cfg: GMappingConfig, view, scan, res, key):
    """Optional per-particle refine pass (monotone, like engine._refine)."""
    if cfg.refine_matcher is None:
        return res
    rc_default, rf = matcherslib.MATCHERS[cfg.refine_matcher]
    rcfg = cfg.refine_cfg if cfg.refine_cfg is not None else rc_default()
    return rf(view, scan, res.pose, key, rcfg, None)


def match_particle(
    cfg: GMappingConfig, view, scan, prior_p: Array, center_p: Array,
    sigma: Array, key_p: Array,
):
    """ONE particle's full match pipeline: primary match -> optional refine
    -> minimumScore gate -> proposal-specific (pose, log-weight increment).

    The single source of truth shared by the single-device step (both map
    storages) AND the EP / EP x TP sharded steps (parallel/ep_cow.py,
    parallel/ep2d.py) — sharded and unsharded RBPF runs stay equivalent for
    EVERY config (proposal, refine_matcher, min_match_prob) because they
    execute this same function with the same per-particle key.
    ``center_p`` is the NOISELESS motion center (improved-proposal tau
    weighting); ``sigma`` the motion-model spread.
    """
    _, match_fn = matcherslib.MATCHERS[cfg.matcher]
    if cfg.proposal == "improved":
        k_m, k_prop = jax.random.split(key_p)
        res = match_fn(view, scan, prior_p, k_m, cfg.matcher_cfg, None)
        res = _refine_rbpf(cfg, view, scan, res, k_m)
        res = _gate_match(cfg, view, scan, res, prior_p)
        return _improved_proposal(view, scan, res, center_p, sigma, k_prop, cfg)
    res = match_fn(view, scan, prior_p, key_p, cfg.matcher_cfg, None)
    res = _refine_rbpf(cfg, view, scan, res, key_p)
    res = _gate_match(cfg, view, scan, res, prior_p)
    return res.pose, cfg.weight_gamma * jnp.log(res.prob + 1e-6)


def gmapping_step(
    cfg: GMappingConfig, state: GMappingState, scan: LaserScan, odom_delta: Array
) -> GMappingState:
    """One RBPF step: propose -> match -> weight -> insert -> resample."""
    p = cfg.n_particles
    key, k_noise, k_match, k_res = jax.random.split(state.key, 4)

    # 1. proposal: odometry + per-particle motion-model noise (BOTH modes —
    # the pre-match spread is what puts at least some particles inside the
    # matcher's convergence basin when odometry error exceeds it; dropping
    # it reduces the filter to a replicated single hypothesis). The
    # improved proposal additionally needs the NOISELESS motion centers:
    # its tau weights score probes against the motion model p(x | x_prev,
    # u), whose center is x_prev ⊕ u, not the particle's noisy draw.
    base = jnp.array([cfg.noise_xy, cfg.noise_xy, cfg.noise_theta])
    alpha = jnp.array([cfg.alpha_xy, cfg.alpha_xy, cfg.alpha_theta])
    sigma = base + alpha * jnp.abs(odom_delta)
    noise = jax.random.normal(k_noise, (p, 3)) * sigma
    priors = compose(state.poses, odom_delta[None, :] + noise)
    motion_centers = compose(state.poses, jnp.broadcast_to(odom_delta, (p, 3)))

    keys = jax.random.split(k_match, p)

    if cfg.map_storage == "cow":
        from ..ops import cow

        wt = cfg.window_tiles

        # 2. per-particle scan match against a window of the particle's map
        def match_one(p_idx, prior_p, center_p, key_p):
            win = cow.extract_window(
                state.gm, cfg.cell_model, p_idx, prior_p[:2], wt, wt
            )
            view = scoring.MapView.of(win, cfg.cell_model)
            return match_particle(cfg, view, scan, prior_p, center_p, sigma, key_p)

        poses, incr = jax.vmap(match_one)(
            jnp.arange(p), priors, motion_centers, keys
        )

        # 3. weight update
        logw = resample.normalize_log_weights(state.log_weights + incr)

        # 4. insert: rasterize per particle, CoW-prepare touched tiles,
        # one shared-pool scatter
        rows, cols, w, s = jax.vmap(
            lambda pose_p: raycast.scan_sample_cells(
                state.gm.origin, state.gm.scale, pose_p, scan, cfg.beam
            )
        )(poses)  # each [P, M]
        pid = jnp.broadcast_to(jnp.arange(p)[:, None], rows.shape)
        b = state.gm.block
        th, tw = state.gm.tables.shape[1:]
        tr = jnp.clip(rows // b, 0, th - 1)
        tc = jnp.clip(cols // b, 0, tw - 1)
        ok = (w > 0) & (rows >= 0) & (rows < th * b) & (cols >= 0) & (cols < tw * b)
        touched = jnp.zeros((p, th, tw), bool).at[pid, tr, tc].max(ok, mode="drop")
        gm = cow.prepare_write(state.gm, cfg.cell_model, touched)
        gm = cow.scatter_observations(
            gm, cfg.cell_model, pid.ravel(), rows.ravel(), cols.ravel(),
            w.ravel(), s.ravel(),
        )

        # 5. resample: tables gather only (the CoW win)
        idx, logw, _ = resample.maybe_resample(k_res, logw, cfg.resample_threshold)
        gm = cow.resample(gm, idx)
        poses = poses[idx]
        return (
            GMappingState(
                gm=gm, poses=poses, log_weights=logw, key=key, step=state.step + 1
            ),
            idx,
        )

    # 2. per-particle scan match against the particle's OWN map
    def match_one(gm_p, prior_p, center_p, key_p):
        view = scoring.MapView.of(gm_p, cfg.cell_model)
        if cfg.match_window:
            win_fn = (
                scoring.window_view_onehot
                if cfg.match_window_impl == "onehot"
                else scoring.window_view
            )
            view = win_fn(view, prior_p[:2], cfg.match_window)
        return match_particle(cfg, view, scan, prior_p, center_p, sigma, key_p)

    poses, incr = jax.vmap(match_one)(state.gm, priors, motion_centers, keys)

    # 3. weight update: w *= marginal (improved) or mode^gamma (odom)
    logw = resample.normalize_log_weights(state.log_weights + incr)

    # 4. insert scan into every particle map
    def insert_one(gm_p, pose_p):
        if not cfg.insert_window:
            return raycast.insert_scan(gm_p, cfg.cell_model, pose_p, scan, cfg.beam)
        # windowed insert: rasterize + fold on a pose-centered window (cells
        # outside it are untouched by construction once endpoint evidence
        # respects max_range)
        h, w, c = gm_p.cells.shape
        wi = min(cfg.insert_window, h, w)
        rel = (pose_p[:2] - gm_p.origin) / gm_p.scale
        col = jnp.clip(jnp.floor(rel[0]).astype(jnp.int32) - wi // 2, 0, w - wi)
        row = jnp.clip(jnp.floor(rel[1]).astype(jnp.int32) - wi // 2, 0, h - wi)
        win_origin = (
            gm_p.origin + jnp.stack([col, row]).astype(jnp.float32) * gm_p.scale
        )
        if cfg.insert_impl == "onehot":
            # separable one-hot extraction: sub = Er @ cells @ Ec^T. One-hot
            # f32 matmuls at HIGHEST precision are exact, and under vmap
            # this is one batched [P,wi,H]x[P,H,W] matmul instead of P
            # window gathers.
            er = (
                (row + jnp.arange(wi))[:, None] == jnp.arange(h)[None, :]
            ).astype(jnp.float32)  # [wi, H]
            ec = (
                (col + jnp.arange(wi))[:, None] == jnp.arange(w)[None, :]
            ).astype(jnp.float32)  # [wi, W]
            # precision pinned so the non-one-hot operand is never truncated
            # (TF32 on GPUs) by the backend default — exact by construction
            hi = jax.lax.Precision.HIGHEST
            sub = jnp.einsum("rh,hwc->rwc", er, gm_p.cells, precision=hi)
            sub = jnp.einsum("sw,rwc->rsc", ec, sub, precision=hi)
            sub_gm = gridlib.GridMap(cells=sub, origin=win_origin, scale=gm_p.scale)
            sub_gm = raycast.insert_scan(sub_gm, cfg.cell_model, pose_p, scan, cfg.beam)
            # masked write-back: select(mask, Er^T @ sub_new @ Ec, cells) —
            # untouched cells are passed through by selection, so they stay
            # bitwise intact even if a cell channel is ever non-finite
            scat = jnp.einsum("rh,rsc->hsc", er, sub_gm.cells, precision=hi)
            scat = jnp.einsum("sw,hsc->hwc", ec, scat, precision=hi)
            mask = (er.sum(0)[:, None] * ec.sum(0)[None, :]) > 0.5
            return gm_p.replace(
                cells=jnp.where(mask[:, :, None], scat, gm_p.cells)
            )
        sub = jax.lax.dynamic_slice(gm_p.cells, (row, col, 0), (wi, wi, c))
        sub_gm = gridlib.GridMap(cells=sub, origin=win_origin, scale=gm_p.scale)
        sub_gm = raycast.insert_scan(sub_gm, cfg.cell_model, pose_p, scan, cfg.beam)
        return gm_p.replace(
            cells=jax.lax.dynamic_update_slice(gm_p.cells, sub_gm.cells, (row, col, 0))
        )

    gm = jax.vmap(insert_one)(state.gm, poses)

    # 5. conditional systematic resampling; the (P, H, W, C) map gather is
    # the expensive part, so it runs under a real branch (lax.cond executes
    # one side) and is skipped entirely while Neff stays healthy
    idx, logw, did = resample.maybe_resample(k_res, logw, cfg.resample_threshold)
    gm = jax.lax.cond(
        did,
        lambda g: jax.tree.map(lambda a: a[idx], g),
        lambda g: g,
        gm,
    )
    poses = poses[idx]

    return (
        GMappingState(
            gm=gm, poses=poses, log_weights=logw, key=key, step=state.step + 1
        ),
        idx,
    )


def best_particle(state: GMappingState) -> Array:
    return jnp.argmax(state.log_weights)


def estimate_pose(state: GMappingState) -> Array:
    """Pose of the highest-weight particle (reference convention)."""
    return state.poses[best_particle(state)]


def neff(state: GMappingState) -> Array:
    return resample.effective_sample_size(state.log_weights)


@partial(jax.jit, static_argnums=0, donate_argnums=1)
def run_sequence(
    cfg: GMappingConfig, state: GMappingState, scans: LaserScan, odom: Array
):
    """Whole-sequence device-resident RBPF run.

    Returns (final state, best-particle per-step pose f32[T, 3], Neff
    f32[T], all particle poses f32[T, P, 3], ancestors i32[T, P]).
    The last two reconstruct genealogy-consistent per-particle
    trajectories (the reference stores a trajectory per particle) via
    :func:`winner_trajectory`.
    """

    def body(st, inp):
        scan, od = inp
        st, anc = gmapping_step(cfg, st, scan, od)
        return st, (estimate_pose(st), neff(st), st.poses, anc)

    state, (traj, neffs, all_poses, ancestors) = jax.lax.scan(
        body, state, (scans, odom)
    )
    return state, traj, neffs, all_poses, ancestors


def winner_trajectory(all_poses: Array, ancestors: Array, winner) -> Array:
    """Backtrack the genealogy of particle ``winner`` at the final step.

    all_poses: f32[T, P, 3]; ancestors: i32[T, P] (ancestors[t, i] = index
    BEFORE step t's resample of the particle stored at slot i after it).
    Returns the ancestral pose path f32[T, 3] — the RBPF trajectory
    estimate, consistent across resampling events.
    """
    t = all_poses.shape[0]

    def back(i, carry):
        idx, out = carry
        step_i = t - 1 - i
        out = out.at[step_i].set(all_poses[step_i, idx])
        idx = ancestors[step_i, idx]
        return idx, out

    _, out = jax.lax.fori_loop(
        0, t, back, (jnp.asarray(winner, jnp.int32), jnp.zeros((t, 3)))
    )
    return out


def weighted_mean_trajectory(
    all_poses: Array, ancestors: Array, log_weights: Array
) -> Array:
    """Posterior-mean trajectory: the weight-softmax mix of EVERY final
    particle's genealogy-consistent path (circular mean for headings).

    The reference convention (and :func:`winner_trajectory`) outputs the
    MAP particle's path; on fp-knife-edge benches the argmax winner flips
    between near-tied particles and the reported ATE inherits that
    variance. The expectation under the final weights is a smoother
    estimator of the same posterior — a capability the batched genealogy
    arrays give almost for free (one vmap'd backtrack over particles).
    """
    p = all_poses.shape[1]
    trajs = jax.vmap(lambda i: winner_trajectory(all_poses, ancestors, i))(
        jnp.arange(p)
    )  # [P, T, 3]
    w = jax.nn.softmax(log_weights)
    xy = (w[:, None, None] * trajs[..., :2]).sum(0)
    s = (w[:, None] * jnp.sin(trajs[..., 2])).sum(0)
    c = (w[:, None] * jnp.cos(trajs[..., 2])).sum(0)
    return jnp.concatenate([xy, jnp.arctan2(s, c)[..., None]], axis=-1)


class GMappingEngine:
    """Host driver mirroring models.engine.Engine for the RBPF world."""

    def __init__(self, cfg: GMappingConfig | None = None, key=None, **kwargs):
        if cfg is None:
            cfg = GMappingConfig(**kwargs)
        self.cfg = cfg
        self.state = init_state(cfg, key)
        self._step = jax.jit(partial(gmapping_step, cfg))
        self.trajectory: list = []
        #: (all_poses [T, P, 3], ancestors [T, P]) from the last offline run
        self.genealogy = None

    #: online mode: poll the CoW pool-overflow latch every this many scans
    #: (a host sync, so not every step) and grow the pool 2x when it fires —
    #: the host re-shard event the overflow flag exists for
    overflow_check_every: int = 32

    def handle_scan(self, scan: LaserScan, odom_delta: Array) -> Array:
        self.state, _ = self._step(self.state, scan, odom_delta)
        pose = estimate_pose(self.state)
        self.trajectory.append(pose)
        if (
            self.cfg.map_storage == "cow"
            and len(self.trajectory) % self.overflow_check_every == 0
            and bool(self.state.gm.overflow)
        ):
            self._grow_pool()
        return pose

    def _grow_pool(self) -> None:
        from ..ops import cow

        new_cap = 2 * self.state.gm.capacity
        self.state = self.state.replace(
            gm=cow.grow_pool(self.state.gm, self.cfg.cell_model, new_cap)
        )
        # shapes changed: the jitted step retraces on next call

    def run(self, scans: LaserScan, odom: Array):
        self.state, traj, neffs, all_poses, ancestors = run_sequence(
            self.cfg, self.state, scans, odom
        )
        self.genealogy = (all_poses, ancestors)
        self.trajectory.extend(list(traj))
        return traj, neffs

    def winner_trajectory(self) -> Array:
        """Genealogy-consistent trajectory of the final best particle."""
        assert self.genealogy is not None, "run() first"
        return winner_trajectory(*self.genealogy, best_particle(self.state))

    @property
    def occupancy(self) -> Array:
        i = best_particle(self.state)
        if self.cfg.map_storage == "cow":
            from ..ops import cow

            th, tw = self.state.gm.tables.shape[1:]
            win = cow.extract_window(
                self.state.gm, self.cfg.cell_model, i, jnp.zeros(2), th, tw
            )
            return gridlib.occupancy_plane(win, self.cfg.cell_model)
        gm_best = jax.tree.map(lambda a: a[i], self.state.gm)
        return gridlib.occupancy_plane(gm_best, self.cfg.cell_model)


def fast_config(
    n_particles: int = 30,
    map_size: int = 256,
    map_scale: float = 0.1,
    usable_range: float = 6.0,
    proposal: str = "odom",
    stride: int = 2,
) -> GMappingConfig:
    """The fast operating point at 30 particles: f32 one-hot overlap
    scoring, 5 Monte-Carlo rounds, usable-range-capped insertion
    (GMapping's maxUrange) with pose-centered insert/match windows sized
    to cover it exactly, and stride-``stride`` beam subsampling in the
    matcher (the reference SPE's skip knob).

    How the point was chosen (5-seed 2-lap winner ATE):
    - usable_range 6 m is the QUALITY anchor: mean/max = 0.158/0.299 m,
      vs 0.35+ at 4 m and 0.54 at 8 m. 160-cell windows are robust; the
      tighter 128 snap diverges on 2/5 seeds (mean 0.87) — do not shrink
      the match window below the usable reach.
    - stride=2 halves the scoring work, costing ~0.02 m of 5-seed mean
      ATE at 120 beams (0.179 vs 0.158) and less at denser scans.
      stride=1 recovers the quality point.
    - part of stride-2's headroom is spent back on the search: MC
      batch=20 with a TIGHTER proposal sigma (0.06/0.03 — the score
      surface at these window/stride shapes is informative at cell
      scale, and the narrower search converges harder): mean/max =
      0.106/0.119 m, vs 0.127/0.184 for the sigma-0.08/batch-16 point.

    Window arithmetic: reach = (usable_range + hole_width)/scale +
    margin; windows snap up to cover 2x reach.
    """
    cells_reach = int(-(-(usable_range + 0.3) // map_scale)) + 4
    win = min(2 * ((cells_reach + 15) // 16 * 16), map_size)
    cfg = GMappingConfig(
        n_particles=n_particles,
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
        matcher_cfg=matcherslib.MonteCarloConfig(
            sigma_xy=0.06, sigma_theta=0.03, batch=20, rounds=5,
            scoring=_fast_scoring(stride),
        ),
        match_window=win,
        insert_window=win,
        # one-hot matmul window extraction on both paths (bitwise-equal to
        # 'slice'); which form is faster on the GPU is not yet measured
        match_window_impl="onehot",
        insert_impl="onehot",
        beam=raycast.BeamConfig(max_range=usable_range),
        proposal=proposal,
    )
    if proposal == "improved":
        # 5-seed: gamma=16/thr=0.8 measured 2x worse than odom;
        # gamma=8/thr=0.5 is the best measured improved point at fast shapes — and still
        # loses to 'odom' (5-seed winner ATE mean 0.40 vs 0.16; DESIGN
        # §9b). The knob stays (the improved proposal WINS at the
        # default/quality shapes under high odometry noise, DESIGN §9),
        # but at fast shapes you are opting into measured-worse quality.
        import warnings

        warnings.warn(
            "fast_config(proposal='improved') measured WORSE than 'odom' "
            "at the fast operating point (5-seed winner ATE 0.40 vs 0.16; "
            "DESIGN §9b). Use proposal='odom' unless odometry noise is far above "
            "the bench's.", stacklevel=2,
        )
        cfg = dataclasses.replace(
            cfg, resample_threshold=0.5, weight_gamma=8.0
        )
    return cfg


def _fast_scoring(stride: int = 1):
    from ..ops import scoring as scoringlib

    # f32: the same 2-lap ATE as bf16 operands, and exact numerics
    return scoringlib.ScoringConfig(
        reducer="overlap", window=1, dtype="float32", stride=stride
    )
