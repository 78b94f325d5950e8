"""Pose-recovery tests mirroring the reference's scan-matcher test strategy
(SURVEY.md §4): build a synthetic world, render a perfect scan from a true
pose, displace the initial guess, assert the matcher recovers the pose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.ops import cells, grid, matchers, raycast, scoring
from slam_constructor_tpu.utils import datagen


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=5, seed=2)
    bearings = datagen.default_bearings(180)
    true_pose = jnp.array([0.3, -0.2, 0.15])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    # build the map from a few nearby viewpoints so matching has support
    for dp in [jnp.zeros(3), jnp.array([0.1, 0.0, 0.0]), jnp.array([0.0, 0.1, 0.0])]:
        p = true_pose + dp
        sp = raycast.cast_rays(occ, origin, scale, p, bearings)
        gm = raycast.insert_scan(gm, model, p, sp, raycast.BeamConfig())
    view = scoring.MapView.of(gm, model)
    return view, s, true_pose


DISPLACEMENT = jnp.array([0.18, -0.14, 0.06])
SCORING = scoring.ScoringConfig(reducer="mean", window=1)


def recovered(result, true_pose, tol_xy=0.08, tol_th=0.05):
    err = np.asarray(result.pose - true_pose)
    return abs(err[0]) < tol_xy and abs(err[1]) < tol_xy and abs(err[2]) < tol_th


def test_monte_carlo_recovers_pose(setup):
    view, s, true_pose = setup
    cfg = matchers.MonteCarloConfig(batch=48, rounds=16, scoring=SCORING)
    res = matchers.monte_carlo_match(
        view, s, true_pose + DISPLACEMENT, jax.random.PRNGKey(3), cfg
    )
    assert recovered(res, true_pose)


def test_monte_carlo_window_view_recovers_pose(setup):
    """Local matching against a robot-centered window_view (the surviving
    FLOP-reduction path after the per-beam window deletion — see
    ops/scoring.py post-mortem note) recovers the pose like the full view
    when the window covers the scan footprint."""
    from slam_constructor_tpu.ops import scoring as sclib

    view, s, true_pose = setup
    win = sclib.window_view(view, true_pose[:2] + DISPLACEMENT[:2], 160)
    cfg = matchers.MonteCarloConfig(
        sigma_xy=0.1, sigma_theta=0.03, batch=48, rounds=16, scoring=SCORING,
    )
    res = matchers.monte_carlo_match(
        win, s, true_pose + DISPLACEMENT, jax.random.PRNGKey(3), cfg
    )
    assert recovered(res, true_pose)
    assert float(res.prob) > 0.55  # real in-window evidence, not backfill


def test_hill_climbing_recovers_pose(setup):
    view, s, true_pose = setup
    cfg = matchers.HillClimbingConfig(iterations=24, scoring=SCORING)
    res = matchers.hill_climbing_match(view, s, true_pose + DISPLACEMENT, None, cfg)
    assert recovered(res, true_pose)


def test_brute_force_recovers_pose(setup):
    view, s, true_pose = setup
    cfg = matchers.BruteForceConfig(
        half_x=0.3, half_y=0.3, half_theta=0.12, n_x=13, n_y=13, n_theta=7,
        scoring=SCORING,
    )
    res = matchers.brute_force_match(view, s, true_pose + DISPLACEMENT, None, cfg)
    assert recovered(res, true_pose, tol_xy=0.1, tol_th=0.06)


def test_matcher_improves_probability(setup):
    view, s, true_pose = setup
    init = true_pose + DISPLACEMENT
    p0 = scoring.score_single(view, s, init, SCORING)
    cfg = matchers.MonteCarloConfig(batch=48, rounds=16, scoring=SCORING)
    res = matchers.monte_carlo_match(view, s, init, jax.random.PRNGKey(0), cfg)
    assert float(res.prob) >= float(p0)


def test_matchers_jit(setup):
    view, s, true_pose = setup
    cfg = matchers.MonteCarloConfig(batch=8, rounds=4, scoring=SCORING)
    f = jax.jit(lambda v, sc, p, k: matchers.monte_carlo_match(v, sc, p, k, cfg))
    res = f(view, s, true_pose, jax.random.PRNGKey(0))
    assert res.pose.shape == (3,)


def test_gradient_recovers_pose(setup):
    view, s, true_pose = setup
    cfg = matchers.GradientConfig(
        iterations=32, scoring=scoring.ScoringConfig(reducer="overlap")
    )
    res = matchers.gradient_match(view, s, true_pose + DISPLACEMENT, None, cfg)
    assert recovered(res, true_pose)


def test_gradient_matcher_registered():
    assert "gradient" in matchers.MATCHERS


@pytest.fixture(scope="module")
def empty_map():
    """An empty map (every beam reads unknown_prob), a scan, and
    non-uniform per-beam weights like vinySLAM's angle histogram."""
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=5, seed=2)
    pose = jnp.array([0.3, -0.2, 0.15])
    s = raycast.cast_rays(occ, origin, scale, pose, datagen.default_bearings(360))
    model = cells.TBMCell()
    view = scoring.MapView.of(grid.make_grid_map(model, 80, 80, 0.1), model)
    pw = jax.random.uniform(jax.random.PRNGKey(5), (360,), minval=0.2, maxval=3.0)
    return view, s, pose, pw


@pytest.mark.parametrize("reducer", ["obstacle", "mean", "overlap", "max"])
def test_flat_map_scores_equal(empty_map, reducer):
    """On a flat score surface a pose scored alone and every row of a
    candidate batch read the same value."""
    view, s, pose, pw = empty_map
    cfg = scoring.ScoringConfig(reducer=reducer, stride=2)
    cand = pose + jax.random.normal(jax.random.PRNGKey(1), (32, 3)) * 0.1
    one = scoring.score_single(view, s, pose, cfg, pw)
    rows = scoring.score_poses(view, s, cand, cfg, pw)
    np.testing.assert_array_equal(np.asarray(rows), np.full(32, float(one)))


@pytest.mark.parametrize("matcher", ["monte_carlo", "hill_climbing"])
@pytest.mark.parametrize("reducer", ["obstacle", "overlap"])
def test_flat_map_keeps_incumbent(empty_map, matcher, reducer):
    """A matcher accepts a candidate only if it scores strictly above the
    incumbent, so on an empty map it returns the prior pose unchanged
    (the first scan of a sequence is matched against an empty map)."""
    view, s, pose, pw = empty_map
    cfg_cls, match = matchers.MATCHERS[matcher]
    cfg = cfg_cls(scoring=scoring.ScoringConfig(reducer=reducer, stride=2))
    f = jax.jit(lambda v, sc, p, k, w: match(v, sc, p, k, cfg, w))
    res = f(view, s, pose, jax.random.PRNGKey(0), pw)
    np.testing.assert_array_equal(np.asarray(res.pose), np.asarray(pose))
    assert float(res.prob) == pytest.approx(0.5)
