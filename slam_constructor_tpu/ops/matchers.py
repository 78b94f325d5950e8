"""Grid scan matchers: Monte-Carlo, hill-climbing, brute-force.

Parity targets (SURVEY.md §2.4, §3.3 [unverified paths]):
- ``MonteCarloScanMatcher`` (``monte_carlo_scan_matcher.h``) — tinySLAM-style
  sampled pose refinement with sigma annealing after repeated failures.
- ``HillClimbingScanMatcher`` (``hill_climbing_scan_matcher.h``) — coordinate
  descent with step halving.
- ``BruteForceScanMatcher`` (``brute_force_scan_matcher.h``) — exhaustive
  (x, y, theta) window search.

Re-design: the reference evaluates ONE candidate per scoring call inside a
serial loop. Here every round scores a BATCH of candidates with a single
``score_poses`` dispatch inside ``lax.scan`` (fixed trip count — predictable
compile, no host round-trips), so the device always sees a [K, R, W] gather.
The M3RSM global matcher lives in ``m3rsm.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import struct
from . import scoring
from .geometry import wrap_angle

Array = jax.Array


@struct.dataclass
class MatchResult:
    pose: Array  # f32[3] refined world pose
    prob: Array  # f32[] scan probability at the refined pose
    #: per-round best probability (the GridScanMatcherObserver hook of the
    #: reference, as data: fixed-length trace; empty for single-shot
    #: matchers)
    trace: Array = struct.field(default_factory=lambda: jnp.zeros((0,)))


def _score_with_incumbent(view, scan, pose, cand, cfg, point_weights):
    """Scores of ``pose`` and of ``cand [K, 3]`` from ONE ``score_poses``
    call, as ``(prob, probs[K])``.

    A matcher accepts a candidate only if it scores strictly above the
    incumbent. Both scores must come from the same reduction: scored in
    separate programs, a flat score surface (an empty map, where every
    beam reads ``unknown_prob``) can read an ulp apart, and the matcher
    then walks off to a random candidate."""
    probs = scoring.score_poses(
        view, scan, jnp.concatenate([pose[None], cand]), cfg, point_weights
    )
    return probs[0], probs[1:]


# --- Monte-Carlo ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MonteCarloConfig:
    sigma_xy: float = 0.2
    sigma_theta: float = 0.1
    #: candidates scored per round (the reference scores 1 per iteration;
    #: batching is the data-parallel replacement for more iterations)
    batch: int = 32
    rounds: int = 12
    #: rounds without improvement before sigma is halved
    bad_rounds_before_anneal: int = 2
    scoring: scoring.ScoringConfig = scoring.ScoringConfig()
    # (a per-beam "beam_window" scoring knob existed in round 1 and was
    # removed: its R-way window gather was a measured on-chip regression —
    # see the post-mortem note in ops/scoring.py and DESIGN.md. Use
    # scoring.window_view / the engines' match_window for local-matcher
    # FLOP reduction instead.)


def monte_carlo_match(
    view: scoring.MapView,
    scan,
    init_pose: Array,
    key: Array,
    cfg: MonteCarloConfig = MonteCarloConfig(),
    point_weights: Array | None = None,
) -> MatchResult:
    def round_fn(carry, key_r):
        best_pose, _, sigma, bad = carry
        noise = jax.random.normal(key_r, (cfg.batch, 3)) * sigma
        cand = jnp.concatenate(
            [best_pose[None, :2] + noise[:, :2],
             wrap_angle(best_pose[None, 2:] + noise[:, 2:])], axis=-1
        )
        inc, probs = _score_with_incumbent(
            view, scan, best_pose, cand, cfg.scoring, point_weights
        )
        i = jnp.argmax(probs)
        better = probs[i] > inc
        best_pose = jnp.where(better, cand[i], best_pose)
        best_prob = jnp.where(better, probs[i], inc)
        bad = jnp.where(better, 0, bad + 1)
        anneal = bad >= cfg.bad_rounds_before_anneal
        sigma = jnp.where(anneal, sigma * 0.5, sigma)
        bad = jnp.where(anneal, 0, bad)
        return (best_pose, best_prob, sigma, bad), probs[i]

    sigma0 = jnp.array([cfg.sigma_xy, cfg.sigma_xy, cfg.sigma_theta], jnp.float32)
    keys = jax.random.split(key, cfg.rounds)
    (pose, prob, _, _), trace = jax.lax.scan(
        round_fn, (init_pose, jnp.float32(-jnp.inf), sigma0, jnp.int32(0)), keys
    )
    return MatchResult(pose=pose, prob=prob, trace=trace)


# --- hill climbing ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HillClimbingConfig:
    step_xy: float = 0.1
    step_theta: float = 0.05
    iterations: int = 12
    #: step shrink factor applied when no axis improves
    shrink: float = 0.5
    scoring: scoring.ScoringConfig = scoring.ScoringConfig()


def hill_climbing_match(
    view: scoring.MapView,
    scan,
    init_pose: Array,
    key: Array | None = None,
    cfg: HillClimbingConfig = HillClimbingConfig(),
    point_weights: Array | None = None,
) -> MatchResult:
    del key  # deterministic
    # the six axis-step candidates, as offsets scaled by the live step sizes
    units = jnp.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        jnp.float32,
    )

    def iter_fn(carry, _):
        pose, _, steps = carry
        cand = pose[None, :] + units * steps[None, :]
        cand = cand.at[:, 2].set(wrap_angle(cand[:, 2]))
        inc, probs = _score_with_incumbent(
            view, scan, pose, cand, cfg.scoring, point_weights
        )
        i = jnp.argmax(probs)
        better = probs[i] > inc
        pose = jnp.where(better, cand[i], pose)
        prob = jnp.where(better, probs[i], inc)
        steps = jnp.where(better, steps, steps * cfg.shrink)
        return (pose, prob, steps), prob

    steps0 = jnp.array([cfg.step_xy, cfg.step_xy, cfg.step_theta], jnp.float32)
    (pose, prob, _), trace = jax.lax.scan(
        iter_fn, (init_pose, jnp.float32(-jnp.inf), steps0), None,
        length=cfg.iterations,
    )
    return MatchResult(pose=pose, prob=prob, trace=trace)


# --- brute force ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BruteForceConfig:
    half_x: float = 0.5
    half_y: float = 0.5
    half_theta: float = 0.2
    n_x: int = 11
    n_y: int = 11
    n_theta: int = 9
    #: candidates per score dispatch (memory cap for the [K, R, W] gather)
    chunk: int = 512
    scoring: scoring.ScoringConfig = scoring.ScoringConfig()


def brute_force_match(
    view: scoring.MapView,
    scan,
    init_pose: Array,
    key: Array | None = None,
    cfg: BruteForceConfig = BruteForceConfig(),
    point_weights: Array | None = None,
) -> MatchResult:
    del key
    dx = jnp.linspace(-cfg.half_x, cfg.half_x, cfg.n_x)
    dy = jnp.linspace(-cfg.half_y, cfg.half_y, cfg.n_y)
    dth = jnp.linspace(-cfg.half_theta, cfg.half_theta, cfg.n_theta)
    gx, gy, gt = jnp.meshgrid(dx, dy, dth, indexing="ij")
    offsets = jnp.stack([gx, gy, gt], axis=-1).reshape(-1, 3)  # dense 3D grid
    cand = init_pose[None, :] + offsets
    cand = cand.at[:, 2].set(wrap_angle(cand[:, 2]))

    k = cand.shape[0]
    pad = (-k) % cfg.chunk
    cand_p = jnp.concatenate([cand, jnp.broadcast_to(init_pose, (pad, 3))], 0)
    chunks = cand_p.reshape(-1, cfg.chunk, 3)

    def chunk_fn(c):
        return scoring.score_poses(view, scan, c, cfg.scoring, point_weights)

    probs = jax.lax.map(chunk_fn, chunks).reshape(-1)
    probs = jnp.where(jnp.arange(probs.shape[0]) < k, probs, -jnp.inf)
    i = jnp.argmax(probs)
    return MatchResult(pose=cand_p[i], prob=probs[i])


# --- gradient-guided (JAX-native; no reference counterpart) ------------------


@dataclasses.dataclass(frozen=True)
class GradientConfig:
    """Gradient-ascent refinement through the differentiable overlap score.

    The overlap-weighted reducer is continuous in the pose (fractional
    endpoint-square/cell overlaps), so ``jax.grad`` of the scan probability
    gives an ascent direction for free through the sampling matmuls —
    something the reference's pointer-chased virtual scoring cannot express
    (gradient-guided proposals appear in the GPU-PF literature, e.g.
    arXiv:2504.18056; idea only). Steps use hill-climbing's keep-if-better +
    shrink-on-failure rule, so the matcher is monotone like the others.
    """

    iterations: int = 24
    step_xy: float = 0.06
    step_theta: float = 0.03
    shrink: float = 0.5
    scoring: scoring.ScoringConfig = scoring.ScoringConfig(reducer="overlap")


def gradient_match(
    view: scoring.MapView,
    scan,
    init_pose: Array,
    key: Array | None = None,
    cfg: GradientConfig = GradientConfig(),
    point_weights: Array | None = None,
) -> MatchResult:
    del key  # deterministic

    def score_fn(pose):
        return scoring.score_single(view, scan, pose, cfg.scoring, point_weights)

    grad_fn = jax.grad(score_fn)
    init_prob = score_fn(init_pose)

    def iter_fn(carry, _):
        pose, prob, steps = carry
        g = grad_fn(pose)
        gn = g / (jnp.linalg.norm(g) + 1e-12)
        cand = pose + steps * gn
        cand = cand.at[2].set(wrap_angle(cand[2]))
        p_new = score_fn(cand)
        better = p_new > prob
        pose = jnp.where(better, cand, pose)
        prob = jnp.where(better, p_new, prob)
        steps = jnp.where(better, steps, steps * cfg.shrink)
        return (pose, prob, steps), prob

    steps0 = jnp.array([cfg.step_xy, cfg.step_xy, cfg.step_theta], jnp.float32)
    (pose, prob, _), trace = jax.lax.scan(
        iter_fn, (init_pose, init_prob, steps0), None, length=cfg.iterations
    )
    return MatchResult(pose=pose, prob=prob, trace=trace)


#: registry for the config system (matcher chosen by properties key in the
#: reference's init_utils — SURVEY.md §2.7)
MATCHERS = {
    "monte_carlo": (MonteCarloConfig, monte_carlo_match),
    "hill_climbing": (HillClimbingConfig, hill_climbing_match),
    "brute_force": (BruteForceConfig, brute_force_match),
    "gradient": (GradientConfig, gradient_match),
}
