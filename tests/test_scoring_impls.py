"""Gather vs one-hot matmul scoring paths must agree to fp32 rounding, and
'auto' must be the gather sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.ops import cells, grid, raycast, scoring
from slam_constructor_tpu.utils import datagen


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=5, seed=3)
    bearings = datagen.default_bearings(120)
    tp = jnp.array([0.3, -0.2, 0.15])
    s = raycast.cast_rays(occ, origin, scale, tp, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    gm = raycast.insert_scan(gm, model, tp, s, raycast.BeamConfig(wall_blur=True))
    view = scoring.MapView.of(gm, model)
    # candidates spread wide so many endpoints fall off-map (coverage path)
    cand = tp[None, :] + jax.random.normal(jax.random.PRNGKey(0), (24, 3)) * jnp.array(
        [1.5, 1.5, 0.4]
    )
    return view, s, cand


@pytest.mark.parametrize(
    "reducer,window,extent",
    [
        ("obstacle", 1, 1.0),
        ("mean", 1, 1.0),
        ("mean", 2, 1.0),
        ("overlap", 1, 1.0),
        ("overlap", 1, 1.6),
        ("overlap", 2, 2.0),
    ],
)
def test_matmul_matches_gather(setup, reducer, window, extent):
    view, s, cand = setup
    kw = dict(reducer=reducer, window=window, overlap_extent=extent)
    got = scoring.score_poses(
        view, s, cand, scoring.ScoringConfig(impl="matmul", **kw)
    )
    want = scoring.score_poses(
        view, s, cand, scoring.ScoringConfig(impl="gather", **kw)
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-6)


def test_matmul_chunked_path(setup):
    view, s, cand = setup
    big = jnp.tile(cand, (40, 1))  # 960 poses x 120 beams > chunk size
    cfg_m = scoring.ScoringConfig(impl="matmul", reducer="overlap")
    cfg_g = scoring.ScoringConfig(impl="gather", reducer="overlap")
    got = scoring.score_poses(view, s, big, cfg_m)
    want = scoring.score_poses(view, s, big, cfg_g)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("reducer", ["obstacle", "mean", "overlap"])
def test_auto_is_gather(setup, reducer):
    """impl='auto' resolves to the gather sampler on every backend, so the
    default scores are bitwise the gather path's."""
    view, s, cand = setup
    got = scoring.score_poses(
        view, s, cand, scoring.ScoringConfig(reducer=reducer, impl="auto")
    )
    want = scoring.score_poses(
        view, s, cand, scoring.ScoringConfig(reducer=reducer, impl="gather")
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
