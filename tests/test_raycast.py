import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.ops import cells, grid, raycast, scan as scanlib
from slam_constructor_tpu.utils import datagen


def test_cast_rays_box():
    # 10m box centered at origin; robot at center; walls at +/-5m
    occ, origin, scale = datagen.box_world(10.0, 0.1, obstacles=0)
    bearings = jnp.array([0.0, np.pi / 2, np.pi, -np.pi / 2], jnp.float32)
    s = raycast.cast_rays(occ, origin, scale, jnp.zeros(3), bearings)
    assert bool(s.valid.all())
    np.testing.assert_allclose(np.asarray(s.ranges), [4.9] * 4, atol=0.1)


def test_cast_rays_rotated_pose():
    occ, origin, scale = datagen.box_world(10.0, 0.1, obstacles=0)
    pose = jnp.array([2.0, 0.0, np.pi], jnp.float32)  # facing -x
    s = raycast.cast_rays(occ, origin, scale, pose, jnp.array([0.0]))
    assert float(s.ranges[0]) == pytest.approx(6.9, abs=0.1)


def test_cast_rays_max_range_invalid():
    occ = jnp.zeros((50, 50))  # empty world, nothing to hit
    s = raycast.cast_rays(occ, jnp.array([-2.5, -2.5]), 0.1, jnp.zeros(3),
                          jnp.array([0.0]), max_range=5.0)
    assert not bool(s.valid[0])


@pytest.mark.parametrize("estimator", ["const", "area"])
def test_insert_scan_marks_walls_and_free(estimator):
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=0)
    bearings = datagen.default_bearings(180)
    true_scan = raycast.cast_rays(occ, origin, scale, jnp.zeros(3), bearings)

    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    cfg = raycast.BeamConfig(occupancy_estimator=estimator)
    gm = raycast.insert_scan(gm, model, jnp.zeros(3), true_scan, cfg)
    est = grid.occupancy_plane(gm, model)
    known = grid.known_mask(gm)

    # free space near the robot is known and free
    c = 40
    assert bool(known[c, c])
    assert float(est[c - 5 : c + 5, c - 5 : c + 5].max()) < 0.2
    # wall cells along +x are occupied
    wall_col = int((3.9 - float(origin[0])) / 0.1)
    assert float(est[c, wall_col]) > 0.5


def test_insert_scan_wall_blur_runs():
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=0)
    bearings = datagen.default_bearings(90)
    s = raycast.cast_rays(occ, origin, scale, jnp.zeros(3), bearings)
    model = cells.BayesBaseCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    cfg = raycast.BeamConfig(wall_blur=True)
    gm = raycast.insert_scan(gm, model, jnp.zeros(3), s, cfg)
    assert float(grid.occupancy_plane(gm, model).max()) > 0.5


def test_insert_is_jittable():
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=0)
    bearings = datagen.default_bearings(90)
    s = raycast.cast_rays(occ, origin, scale, jnp.zeros(3), bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    cfg = raycast.BeamConfig()
    f = jax.jit(lambda g, p, sc: raycast.insert_scan(g, model, p, sc, cfg))
    out = f(gm, jnp.zeros(3), s)
    assert out.cells.shape == gm.cells.shape


def test_synth_sequence_shapes():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.corridor_trajectory(10)
    bearings = datagen.default_bearings(90)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(0)
    )
    assert scans.ranges.shape == (10, 90)
    assert odom.shape == (10, 3)
    # odometry roughly tracks the true +x step of the corridor trajectory
    true_dx = float(poses[1, 0] - poses[0, 0])
    assert float(jnp.abs(odom[1:, 0] - true_dx).max()) < 0.1


def test_scatter_matmul_matches_scatter():
    """One-hot matmul scatter path vs XLA scatter: exact for unit counts,
    bf16-rounded (<0.5%) for fractional blur/area weights."""
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=3, seed=1)
    bearings = datagen.default_bearings(120)
    pose = jnp.array([0.2, -0.1, 0.3])
    s = raycast.cast_rays(occ, origin, scale, pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 96, 96, 0.1)
    for est, blur, tol in [("const", False, 0.0), ("const", True, 5e-3), ("area", False, 5e-3)]:
        a = raycast.insert_scan(gm, model, pose, s, raycast.BeamConfig(
            occupancy_estimator=est, wall_blur=blur, scatter_impl="scatter"))
        b = raycast.insert_scan(gm, model, pose, s, raycast.BeamConfig(
            occupancy_estimator=est, wall_blur=blur, scatter_impl="matmul"))
        d = float(jnp.abs(a.cells - b.cells).max())
        assert d <= tol, (est, blur, d)


def test_sorted_segment_add_exact_and_order_independent():
    """The occupied-evidence accumulation: unit counts sum exactly, the
    fractional wall-blur weights within float32 rounding of float64, and
    the result is BITWISE the same on a second call and for any order of
    the samples that keeps each cell's samples in their order (an atomic
    scatter-add on a GPU sums them in a different order on every run)."""
    rng = np.random.default_rng(0)
    n, h, w = 3000, 40, 50
    rows = rng.integers(-3, h + 3, n).astype(np.int32)
    cols = rng.integers(-3, w + 3, n).astype(np.int32)
    vals = np.stack([rng.choice([1.0, 2 / 3, 4 / 9, 0.0], n),
                     np.ones(n)], -1).astype(np.float32)
    valid = rng.random(n) < 0.9
    got = np.asarray(raycast._sorted_segment_add(
        (h, w), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(valid)))
    ok = valid & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    want = np.zeros((h, w, 2))
    np.add.at(want, (rows[ok], cols[ok]), vals[ok].astype(np.float64))
    np.testing.assert_array_equal(got[..., 1], want[..., 1])  # unit counts
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-5)
    again = np.asarray(raycast._sorted_segment_add(
        (h, w), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(valid)))
    np.testing.assert_array_equal(again, got)
    lin = np.where(ok, rows * w + cols, h * w)
    for seed in range(3):
        # a random order of the cells, each cell's samples in arrival order
        # (the invalid samples, one segment, too)
        rank = np.random.default_rng(seed + 1).permutation(h * w + 1)
        p = np.argsort(rank[lin], kind="stable")
        shuffled = np.asarray(raycast._sorted_segment_add(
            (h, w), jnp.asarray(rows[p]), jnp.asarray(cols[p]),
            jnp.asarray(vals[p]), jnp.asarray(valid[p])))
        np.testing.assert_array_equal(shuffled, got)


def test_polar_free_fill_agrees_with_dda():
    # the dense polar fill must mark (approximately) the same free region
    # as the per-beam DDA trace: same endpoint evidence, >=90% overlap of
    # free cells, comparable total free weight
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=3, seed=2)
    bearings = datagen.default_bearings(360)
    pose = jnp.array([0.4, -0.3, 0.2])
    s = raycast.cast_rays(occ, origin, scale, pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 120, 120, 0.1)
    wd, sd = raycast.scan_observation_planes(gm, pose, s, raycast.BeamConfig(free_impl="dda"))
    wp, sp = raycast.scan_observation_planes(gm, pose, s, raycast.BeamConfig(free_impl="polar"))
    np.testing.assert_allclose(np.asarray(sp), np.asarray(sd))  # endpoints identical
    free_d = (np.asarray(wd - sd) > 0)
    free_p = (np.asarray(wp - sp) > 0)
    overlap = (free_d & free_p).sum() / max(free_d.sum(), 1)
    assert overlap > 0.9, f"free-region overlap {overlap}"
    # polar is conservative (adjacent-beam min): it should not claim much
    # free space the DDA doesn't
    extra = (free_p & ~free_d).sum() / max(free_p.sum(), 1)
    assert extra < 0.1, f"polar-only free fraction {extra}"
    ratio = float(wp.sum() / wd.sum())
    assert 0.7 < ratio < 1.3, f"free mass ratio {ratio}"


def test_polar_free_fill_partial_fov():
    # half-FOV scan: no free evidence behind the robot
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=0, seed=0)
    bearings = datagen.default_bearings(181, fov=jnp.pi)  # [-pi/2, pi/2]
    pose = jnp.array([0.0, 0.0, 0.0])
    s = raycast.cast_rays(occ, origin, scale, pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 120, 120, 0.1)
    wp, sp = raycast.scan_observation_planes(gm, pose, s, raycast.BeamConfig(free_impl="polar"))
    free = np.asarray(wp - sp) > 0
    # cells well behind the robot (x < -0.5 m => col < 55) must stay empty
    assert free[:, :55].sum() == 0
    # ahead: plenty of free cells
    assert free[:, 65:].sum() > 100


@pytest.mark.parametrize("nb", [360, 120, 90])
def test_polar_free_plane_matches_numpy_take(nb):
    """The polar fill's one-hot range lookup must return every beam's range
    exactly: the plane equals one built from the same per-cell geometry
    with a NumPy ``take`` lookup, bitwise (the HIGHEST precision pin; a
    TF32 product would shorten ranges by millimetres)."""
    occ, origin, scale = datagen.cecum_world()
    gm = grid.make_grid_map(cells.BayesAvgCell(), 96, 128, 0.1)
    cfg = raycast.BeamConfig(wall_blur=True, free_impl="polar")
    bearings = datagen.default_bearings(nb)
    pose = jnp.array([0.3, -1.45, 0.7])
    s = raycast.cast_rays(occ, origin, scale, pose, bearings)
    s = s.replace(valid=s.valid & (jnp.arange(nb) % 7 != 3))
    got = np.asarray(
        raycast._polar_free_plane(96, 128, gm.origin, 0.1, pose, s, cfg)
    )
    d, bini, ok, wgt, rng = (
        np.asarray(a)
        for a in raycast._polar_cells(96, 128, gm.origin, 0.1, pose, s)
    )
    cell_range = np.take(rng, bini)
    np.testing.assert_array_equal(
        np.asarray(raycast._polar_range_lookup(jnp.asarray(bini), jnp.asarray(rng))),
        cell_range,
    )
    free = ok & (d < cell_range - cfg.hole_width / 2.0) & (d < cfg.max_range)
    np.testing.assert_array_equal(got, np.where(free, wgt, 0.0))
    assert free.sum() > 100


def test_polar_missing_free_concentrates_at_walls():
    """Characterize the polar fill's documented bias (the r5 viny_m3rsm
    root cause): the free evidence it omits relative to DDA is the
    neighbor-min erosion band AROUND obstacles — an unknown halo that
    global matchers rank across (aliasing wall-adjacent translations)
    while sigma-bounded local matchers never see. The halo must stay a
    small, wall-adjacent fraction; if this starts failing, the polar
    approximation changed character."""
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=3, seed=2)
    bearings = datagen.default_bearings(360)
    pose = jnp.array([0.4, -0.3, 0.2])
    s = raycast.cast_rays(occ, origin, scale, pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 120, 120, 0.1)
    wd, sd = raycast.scan_observation_planes(
        gm, pose, s, raycast.BeamConfig(free_impl="dda"))
    wp, sp = raycast.scan_observation_planes(
        gm, pose, s, raycast.BeamConfig(free_impl="polar"))
    free_d = np.asarray(wd - sd) > 0
    free_p = np.asarray(wp - sp) > 0
    missing = free_d & ~free_p  # DDA-free cells polar leaves unknown
    # wall mask: cells with endpoint (occupied) evidence, dilated 2 cells
    wall = np.asarray(sd) > 0
    k = 2
    dil = wall.copy()
    for _ in range(k):
        d2 = dil.copy()
        d2[1:, :] |= dil[:-1, :]
        d2[:-1, :] |= dil[1:, :]
        d2[:, 1:] |= dil[:, :-1]
        d2[:, :-1] |= dil[:, 1:]
        dil = d2
    at_wall = (missing & dil).sum() / max(missing.sum(), 1)
    assert at_wall > 0.5, f"missing-free cells near walls only {at_wall}"
    # and the halo is small relative to the free region
    assert missing.sum() / max(free_d.sum(), 1) < 0.1
