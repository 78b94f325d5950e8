"""M3RSM correctness vs brute force (reference test strategy — SURVEY.md §4
tests the M3RSM engine against exhaustive search)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.ops import cells, grid, m3rsm, matchers, raycast, scoring
from slam_constructor_tpu.utils import datagen


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=5, seed=4)
    bearings = datagen.default_bearings(180)
    true_pose = jnp.array([0.4, -0.3, 0.2])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    for dp in [jnp.zeros(3), jnp.array([0.15, 0.1, 0.0])]:
        p = true_pose + dp
        sp = raycast.cast_rays(occ, origin, scale, p, bearings)
        gm = raycast.insert_scan(
            gm, model, p, sp, raycast.BeamConfig(wall_blur=True)
        )
    view = scoring.MapView.of(gm, model)
    return view, s, true_pose


def test_pyramid_max_property(setup):
    view, _, _ = setup
    planes = m3rsm.build_pyramid(view, 3, 0.5)
    assert len(planes) == 4
    for lo, hi in zip(planes[:-1], planes[1:]):
        h, w = hi.shape
        # every coarse cell >= all its children
        ph = lo.shape[0] + lo.shape[0] % 2
        pw = lo.shape[1] + lo.shape[1] % 2
        p = np.full((ph, pw), 0.5, np.float32)
        p[: lo.shape[0], : lo.shape[1]] = np.asarray(lo)
        blocks = p.reshape(h, 2, w, 2).max(axis=(1, 3))
        np.testing.assert_allclose(np.asarray(hi), blocks, atol=1e-6)


def test_m3rsm_finds_global_optimum_large_displacement(setup):
    view, s, true_pose = setup
    # displacement far outside any local matcher's basin
    init = true_pose + jnp.array([0.9, -0.8, 0.25])
    cfg = m3rsm.M3RSMConfig(half_x=1.2, half_y=1.2, half_theta=0.35,
                            n_theta=15, beam_width=192, levels=4)
    res = m3rsm.m3rsm_match(view, s, init, None, cfg)
    err = np.asarray(res.pose - true_pose)
    assert abs(err[0]) <= 0.15 and abs(err[1]) <= 0.15, err
    assert abs(err[2]) <= 0.06, err


def test_m3rsm_matches_brute_force(setup):
    """The bounded-frontier search must find a candidate at least as good as
    exhaustive search over the same grid (admissibility check)."""
    view, s, true_pose = setup
    init = true_pose + jnp.array([0.3, 0.2, 0.0])
    sc = scoring.ScoringConfig(reducer="obstacle")
    cfg = m3rsm.M3RSMConfig(half_x=0.4, half_y=0.4, half_theta=0.0,
                            n_theta=1, beam_width=256, levels=3, scoring=sc)
    res = m3rsm.m3rsm_match(view, s, init, None, cfg)

    bf = matchers.BruteForceConfig(
        half_x=0.4, half_y=0.4, half_theta=0.0, n_x=9, n_y=9, n_theta=1,
        scoring=sc,
    )
    res_bf = matchers.brute_force_match(view, s, init, None, bf)
    # m3rsm searches every cell-resolution translation, brute force a coarser
    # 9x9 grid -> m3rsm's optimum cannot be worse
    assert float(res.prob) >= float(res_bf.prob) - 1e-5


def test_m3rsm_jittable(setup):
    view, s, true_pose = setup
    cfg = m3rsm.M3RSMConfig(half_x=0.4, half_y=0.4, n_theta=5, levels=3,
                            beam_width=64)
    f = jax.jit(lambda v, sc, p: m3rsm.m3rsm_match(v, sc, p, None, cfg))
    res = f(view, s, true_pose)
    assert res.pose.shape == (3,)


def test_m3rsm_match_many_matches_single():
    """Batched many-to-many requests == per-request calls (one dispatch)."""
    import numpy as np

    from slam_constructor_tpu.ops import cells, grid, raycast, scoring
    from slam_constructor_tpu.ops.m3rsm import M3RSMConfig, m3rsm_match, m3rsm_match_many
    from slam_constructor_tpu.utils import datagen

    occ, origin, scale = datagen.cecum_world()
    bearings = datagen.default_bearings(90)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 160, 160, 0.1)
    build_pose = jnp.array([0.0, -1.5, 0.0])
    s0 = raycast.cast_rays(occ, origin, scale, build_pose, bearings)
    gm = raycast.insert_scan(gm, model, build_pose, s0, raycast.BeamConfig())
    view = scoring.MapView.of(gm, model)

    cfg = M3RSMConfig(half_x=0.5, half_y=0.5, half_theta=0.2, n_theta=9,
                      levels=3, beam_width=64, refine_iterations=0)
    true_poses = jnp.stack([
        build_pose,
        build_pose + jnp.array([0.3, 0.0, 0.1]),
        build_pose + jnp.array([-0.2, 0.1, -0.05]),
    ])
    scans = jax.vmap(lambda p: raycast.cast_rays(occ, origin, scale, p, bearings))(
        true_poses
    )
    inits = true_poses + jnp.array([0.15, -0.1, 0.05])

    many = jax.jit(lambda sc, ip: m3rsm_match_many(view, sc, ip, cfg))(scans, inits)
    for b in range(3):
        one = m3rsm_match(
            view, jax.tree.map(lambda a: a[b], scans), inits[b], None, cfg
        )
        np.testing.assert_allclose(
            np.asarray(many.pose[b]), np.asarray(one.pose), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(many.prob[b]), np.asarray(one.prob), atol=1e-6
        )


def test_update_pyramid_matches_rebuild(setup):
    """Incremental regional refresh == full rebuild when every changed cell
    lies inside the refreshed region (the RescalableCachingGridMap live-cache
    contract — SURVEY.md §2.3)."""
    view, _, _ = setup
    levels = 3
    planes = m3rsm.build_pyramid(view, levels, 0.5)

    # local edit: bump occupancy in a 20x20 patch
    occ2 = view.occ.at[40:60, 50:70].set(0.9)
    known2 = view.known.at[40:60, 50:70].set(True)
    view2 = scoring.MapView(
        occ=occ2, known=known2, origin=view.origin, scale=view.scale
    )

    full = m3rsm.build_pyramid(view2, levels, 0.5)
    inc = jax.jit(
        lambda pl, v, c: m3rsm.update_pyramid(pl, v, 0.5, c, size=48)
    )(planes, view2, jnp.array([50, 60], jnp.int32))
    assert len(inc) == len(full)
    for a, b in zip(inc, full):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_update_pyramid_rejects_misaligned():
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    view = scoring.MapView.of(gm, model)
    planes = m3rsm.build_pyramid(view, 4, 0.5)
    with pytest.raises(ValueError):  # size 40 is not 2^4-aligned
        m3rsm.update_pyramid(planes, view, 0.5, jnp.array([40, 40]), size=40)
    planes5 = m3rsm.build_pyramid(view, 5, 0.5)  # outside raises: must not throw
    with pytest.raises(ValueError):  # 80 is not 2^5-aligned
        m3rsm.update_pyramid(planes5, view, 0.5, jnp.array([40, 40]), size=32)


def test_m3rsm_rejects_stale_pyramid_shape(setup):
    view, s, true_pose = setup
    cfg = m3rsm.M3RSMConfig(n_theta=3, levels=3, beam_width=32)
    wrong = m3rsm.build_pyramid(
        scoring.MapView(
            occ=jnp.zeros((64, 64)), known=jnp.zeros((64, 64), bool),
            origin=view.origin, scale=view.scale,
        ),
        cfg.levels, 0.5,
    )
    with pytest.raises(ValueError, match="shape"):
        m3rsm.m3rsm_match(view, s, true_pose, None, cfg, pyramid=wrong)


def test_update_pyramid_worst_case_alignment():
    """Regression for the align-down coverage hole: the unaligned window
    start ≡ step-1 (mod step) floors DOWN by step-1 cells, so an edit whose
    high edge sits at center + size//2 - step would escape a window sized by
    the old (too-weak) `bbox + step` rule. pyramid_refresh_size's
    `bbox + 2*step` guarantee must keep incremental == rebuild here."""
    levels = 3
    step = 1 << levels
    h = w = 64
    base = scoring.MapView(
        occ=jnp.full((h, w), 0.2), known=jnp.ones((h, w), bool),
        origin=jnp.zeros(2), scale=0.1,
    )
    planes = m3rsm.build_pyramid(base, levels, 0.5)
    # 16-cell edit ending at row 43; center 35 with size 24 gives unaligned
    # start 23 ≡ 7 (mod 8) -> floors to 16, old window [16, 40) missed rows
    # 40..42 (the advisor's reproduction). The corrected size covers it.
    bbox = 16
    center = jnp.array([35, 35], jnp.int32)
    occ2 = base.occ.at[27:43, 27:43].set(0.95)
    view2 = scoring.MapView(occ=occ2, known=base.known, origin=base.origin,
                            scale=base.scale)
    size = m3rsm.pyramid_refresh_size(bbox, levels, h)
    assert size >= bbox + 2 * step
    inc = m3rsm.update_pyramid(planes, view2, 0.5, center, size=size)
    full = m3rsm.build_pyramid(view2, levels, 0.5)
    for a, b in zip(inc, full):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_m3rsm_cached_pyramid_equals_rebuild(setup):
    """m3rsm_match fed live-maintained planes returns the identical result
    to its internal full rebuild."""
    view, s, true_pose = setup
    # the cache is built directly here (update_pyramid's incremental
    # maintenance is covered separately above); this test checks the
    # pyramid= fast path of m3rsm_match itself
    cfg = m3rsm.M3RSMConfig(half_x=0.4, half_y=0.4, n_theta=5, levels=3,
                            beam_width=64)
    init = true_pose + jnp.array([0.2, -0.15, 0.05])
    cached = m3rsm.build_pyramid(view, cfg.levels, cfg.scoring.unknown_prob)
    a = m3rsm.m3rsm_match(view, s, init, None, cfg)
    b = m3rsm.m3rsm_match(view, s, init, None, cfg, pyramid=cached)
    np.testing.assert_allclose(np.asarray(a.pose), np.asarray(b.pose))
    np.testing.assert_allclose(np.asarray(a.prob), np.asarray(b.prob))


def test_m3rsm_window_equals_full():
    """A prior-centered search window covering the scan's reach must be
    EXACT vs searching over the full planes (round-3 M3RSM cost cut): all
    endpoint samples land inside the window, so every level score — and
    therefore every top-k selection and the refined pose — is identical."""
    import dataclasses

    occ, origin, scale = datagen.box_world(6.0, 0.1, obstacles=4, seed=7)
    bearings = datagen.default_bearings(120)
    true_pose = jnp.array([0.3, -0.2, 0.15])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 160, 160, 0.1)
    gm = raycast.insert_scan(
        gm, model, true_pose, s, raycast.BeamConfig(wall_blur=True)
    )
    view = scoring.MapView.of(gm, model)
    init = true_pose + jnp.array([0.2, -0.15, 0.1])
    base = m3rsm.M3RSMConfig(half_x=0.5, half_y=0.5, half_theta=0.2,
                             n_theta=7, levels=4, beam_width=64)
    res_full = m3rsm.m3rsm_match(view, s, init, None, base)
    res_win = m3rsm.m3rsm_match(
        view, s, init, None, dataclasses.replace(base, window=128)
    )
    np.testing.assert_array_equal(
        np.asarray(res_full.pose), np.asarray(res_win.pose)
    )
    np.testing.assert_array_equal(
        np.asarray(res_full.prob), np.asarray(res_win.prob)
    )
    # off-center prior: the window clamps at the map edge and must still
    # produce the same answer while the scan stays inside the clamped window
    init2 = true_pose + jnp.array([-0.4, 0.3, -0.1])
    res_full2 = m3rsm.m3rsm_match(view, s, init2, None, base)
    res_win2 = m3rsm.m3rsm_match(
        view, s, init2, None, dataclasses.replace(base, window=128)
    )
    np.testing.assert_array_equal(
        np.asarray(res_full2.pose), np.asarray(res_win2.pose)
    )


def test_viny_m3rsm_preset_pins_dda_free_fill():
    """free_impl names a free-space ALGORITHM, and the preset must name
    the per-beam DDA: the polar fill's wall-halo erosion aliases the
    global M3RSM branch-and-bound (5-seed ATE 3.8-5.2 m against 0.07 m
    with DDA). 'auto' is no longer accepted, so no backend can swap the
    algorithm behind the preset."""
    from slam_constructor_tpu.models import viny

    cfg = viny.viny_m3rsm_config()
    assert cfg.beam.free_impl == "dda"
    with pytest.raises(ValueError):
        raycast.BeamConfig(free_impl="auto")


def test_viny_m3rsm_ate_short_sequence():
    """The viny_m3rsm preset at its shipped shapes (360 beams, 256^2 map at
    0.1 m) tracks the first 128 scans of the cecum sequence: ATE 0.069 m
    against 0.132 m dead reckoning. A matcher that drifts off the prior on
    the empty first map reads several times that."""
    from slam_constructor_tpu.models import engine as eng
    from slam_constructor_tpu.models import viny
    from slam_constructor_tpu.ops.geometry import compose
    from slam_constructor_tpu.utils import evaluate

    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=27.2 * 0.7 / 512)[:128]
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360),
        jax.random.PRNGKey(0), odom_noise_xy=0.01, odom_noise_theta=0.005,
    )
    cfg = viny.viny_m3rsm_config(map_size=256)
    st = eng.init_state(cfg).replace(pose=gt[0])
    _, traj, _ = eng.run_sequence(cfg, st, scans, odom)
    _, dead = jax.lax.scan(lambda p, d: (compose(p, d),) * 2, gt[0], odom[1:])
    ate = float(evaluate.ate(traj, gt, align=False))
    ate_odo = float(evaluate.ate(jnp.concatenate([gt[:1], dead]), gt, align=False))
    assert ate < 0.1 and ate < 0.6 * ate_odo, (ate, ate_odo)
