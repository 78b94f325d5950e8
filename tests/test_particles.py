import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.models import gmapping
from slam_constructor_tpu.ops import resample
from slam_constructor_tpu.utils import datagen, evaluate


def test_normalize_log_weights():
    logw = jnp.array([0.0, 1.0, 2.0])
    n = resample.normalize_log_weights(logw)
    assert float(jnp.exp(n).sum()) == pytest.approx(1.0, abs=1e-6)


def test_effective_sample_size_limits():
    uniform = jnp.zeros(10)
    assert float(resample.effective_sample_size(uniform)) == pytest.approx(10.0, abs=1e-3)
    degenerate = jnp.array([0.0] + [-100.0] * 9)
    assert float(resample.effective_sample_size(degenerate)) == pytest.approx(1.0, abs=1e-3)


def test_systematic_resample_proportional():
    logw = jnp.log(jnp.array([0.5, 0.25, 0.125, 0.125]))
    idx = resample.systematic_resample(jax.random.PRNGKey(0), logw, 1000)
    counts = np.bincount(np.asarray(idx), minlength=4) / 1000
    np.testing.assert_allclose(counts, [0.5, 0.25, 0.125, 0.125], atol=0.01)


def test_maybe_resample_skips_when_healthy():
    logw = jnp.zeros(8)  # uniform -> Neff = 8
    idx, new_logw, did = resample.maybe_resample(jax.random.PRNGKey(0), logw, 0.5)
    assert not bool(did)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(8))


def test_maybe_resample_fires_when_degenerate():
    logw = jnp.array([0.0] + [-50.0] * 7)
    idx, new_logw, did = resample.maybe_resample(jax.random.PRNGKey(0), logw, 0.5)
    assert bool(did)
    assert np.asarray(idx).max() == 0  # everyone resampled to particle 0
    assert float(jnp.exp(new_logw).sum()) == pytest.approx(1.0, abs=1e-5)


@pytest.fixture(scope="module")
def sequence():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.corridor_trajectory(20)
    bearings = datagen.default_bearings(90)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(11),
        odom_noise_xy=0.02, odom_noise_theta=0.01,
    )
    return scans, odom, gt


def test_gmapping_tracks(sequence):
    scans, odom, gt = sequence
    cfg = gmapping.GMappingConfig(n_particles=8, map_height=192, map_width=192)
    e = gmapping.GMappingEngine(cfg)
    e.state = e.state.replace(poses=jnp.broadcast_to(gt[0], (8, 3)))
    traj, neffs = e.run(scans, odom)
    err = float(evaluate.ate(traj, gt, align=False))
    assert err < 0.2, f"ATE {err}"
    # weights stay normalized and Neff within [1, P]
    assert float(jnp.exp(e.state.log_weights).sum()) == pytest.approx(1.0, abs=1e-4)
    assert 1.0 <= float(neffs.min()) <= 8.01


def test_gmapping_resample_copies_maps():
    cfg = gmapping.GMappingConfig(n_particles=4, map_height=64, map_width=64)
    st = gmapping.init_state(cfg)
    # make particle 2 dominant and mark its map
    st = st.replace(
        log_weights=jnp.array([-50.0, -50.0, 0.0, -50.0]),
        gm=st.gm.replace(cells=st.gm.cells.at[2, 5, 5, 0].set(0.9)),
    )
    idx, logw, did = resample.maybe_resample(jax.random.PRNGKey(1), st.log_weights, 0.5)
    gm = jax.tree.map(lambda a: a[idx], st.gm)
    assert bool(did)
    np.testing.assert_allclose(np.asarray(gm.cells[:, 5, 5, 0]), 0.9)


def test_gmapping_jit_step(sequence):
    scans, odom, gt = sequence
    cfg = gmapping.GMappingConfig(n_particles=4, map_height=96, map_width=96)
    st = gmapping.init_state(cfg)
    s0 = jax.tree.map(lambda a: a[0], scans)
    st2, _ = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg, s, sc, od))(st, s0, odom[0])
    assert st2.poses.shape == (4, 3)
    assert int(st2.step) == 1


def test_winner_trajectory_genealogy(sequence):
    """Backtracked ancestral trajectory is consistent: each step's pose must
    be one of that step's particle poses, and the final pose equals the
    winner's."""
    scans, odom, gt = sequence
    cfg = gmapping.GMappingConfig(n_particles=6, map_height=192, map_width=192)
    e = gmapping.GMappingEngine(cfg)
    e.state = e.state.replace(poses=jnp.broadcast_to(gt[0], (6, 3)))
    e.run(scans, odom)
    wt = np.asarray(e.winner_trajectory())
    all_poses, ancestors = e.genealogy
    all_poses = np.asarray(all_poses)
    assert wt.shape == (all_poses.shape[0], 3)
    for t in range(all_poses.shape[0]):
        d = np.linalg.norm(all_poses[t] - wt[t][None, :], axis=1)
        assert d.min() < 1e-5
    win = int(gmapping.best_particle(e.state))
    np.testing.assert_allclose(wt[-1], all_poses[-1, win], atol=1e-6)
    # genealogy trajectory should also track ground truth
    from slam_constructor_tpu.utils import evaluate
    assert float(evaluate.ate(jnp.asarray(wt), gt[: len(wt)], align=False)) < 0.3


def test_gmapping_windowed_matching_tracks():
    # match_window + bf16 scoring: in a bounded world whose scan footprint
    # fits the window, the windowed fast path must track like the full-map path.
    # (Corridor worlds are the counterexample — far beams carry the only
    # longitudinal constraint — so match_window stays opt-in; see DESIGN.md.)
    from slam_constructor_tpu.ops import matchers, scoring

    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=3)
    poses = datagen.loop_trajectory(16, radius=2.0)
    bearings = datagen.default_bearings(90)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(5),
        odom_noise_xy=0.02, odom_noise_theta=0.01,
    )
    cfg = gmapping.GMappingConfig(
        n_particles=8, map_height=192, map_width=192, match_window=160,
        matcher_cfg=matchers.MonteCarloConfig(
            sigma_xy=0.08, sigma_theta=0.04, batch=16, rounds=6,
            scoring=scoring.ScoringConfig(dtype="bfloat16"),
        ),
    )
    e = gmapping.GMappingEngine(cfg)
    e.state = e.state.replace(poses=jnp.broadcast_to(gt[0], (8, 3)))
    traj, _ = e.run(scans, odom)
    err = float(evaluate.ate(traj, gt, align=False))
    assert err < 0.2, f"ATE {err}"


def test_gmapping_windowed_insert_matches_full(sequence):
    """insert_window (rasterize+fold on a pose-centered dynamic slice) must
    reproduce the full-plane insert when the window covers the usable range
    (the GMapping maxUrange contract): same steps, same keys => same maps,
    poses and weights up to fp re-association of the window's cell-center
    arithmetic."""
    from slam_constructor_tpu.ops import raycast

    scans, odom, gt = sequence
    beam = raycast.BeamConfig(max_range=3.0)
    mk = lambda iw: gmapping.GMappingConfig(
        n_particles=4, map_height=160, map_width=160, beam=beam,
        insert_window=iw,
    )
    cfg_full, cfg_win = mk(0), mk(96)  # 96/2 cells = 4.8 m > 3 m + margin
    st_f = gmapping.init_state(cfg_full)
    st_w = gmapping.init_state(cfg_win)
    st_f = st_f.replace(poses=jnp.broadcast_to(gt[0], (4, 3)))
    st_w = st_w.replace(poses=jnp.broadcast_to(gt[0], (4, 3)))
    step_f = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg_full, s, sc, od))
    step_w = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg_win, s, sc, od))
    for t in range(4):
        s_t = jax.tree.map(lambda a: a[t], scans)
        st_f, _ = step_f(st_f, s_t, odom[t])
        st_w, _ = step_w(st_w, s_t, odom[t])
        np.testing.assert_allclose(
            np.asarray(st_w.poses), np.asarray(st_f.poses), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(st_w.gm.cells), np.asarray(st_f.gm.cells), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(st_w.log_weights), np.asarray(st_f.log_weights), atol=1e-4
        )


def test_gmapping_onehot_insert_matches_slice(sequence):
    """insert_impl='onehot' (separable one-hot matmul extract + masked matmul
    write-back) must be bitwise-equal to the dynamic-slice window insert:
    the one-hot matmuls and the 0/1 write-back mask are exact in f32."""
    from slam_constructor_tpu.ops import raycast

    scans, odom, gt = sequence
    beam = raycast.BeamConfig(max_range=3.0)
    mk = lambda impl: gmapping.GMappingConfig(
        n_particles=4, map_height=160, map_width=160, beam=beam,
        insert_window=96, insert_impl=impl,
    )
    cfg_s, cfg_o = mk("slice"), mk("onehot")
    st_s = gmapping.init_state(cfg_s)
    st_o = gmapping.init_state(cfg_o)
    st_s = st_s.replace(poses=jnp.broadcast_to(gt[0], (4, 3)))
    st_o = st_o.replace(poses=jnp.broadcast_to(gt[0], (4, 3)))
    step_s = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg_s, s, sc, od))
    step_o = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg_o, s, sc, od))
    for t in range(3):
        s_t = jax.tree.map(lambda a: a[t], scans)
        st_s, _ = step_s(st_s, s_t, odom[t])
        st_o, _ = step_o(st_o, s_t, odom[t])
        np.testing.assert_array_equal(
            np.asarray(st_o.poses), np.asarray(st_s.poses)
        )
        np.testing.assert_array_equal(
            np.asarray(st_o.gm.cells), np.asarray(st_s.gm.cells)
        )


@pytest.mark.slow
def test_rbpf_beats_single_hypothesis_under_noise():
    """The point of the RBPF (SURVEY §3.4): under odometry noise well above
    the matcher's comfort zone, multi-hypothesis tracking with the improved
    proposal + marginal weighting survives where the single-hypothesis
    tracker accumulates map corruption. Two laps (the second lap's revisit
    is where weights discriminate); genealogy-winner trajectory is the
    RBPF's canonical output. Measured margins at this seed: tiny ~0.95 m
    vs RBPF ~0.09 m (6/6 seeds in favor)."""
    import dataclasses

    from slam_constructor_tpu.models import engine as eng, tiny
    from slam_constructor_tpu.ops import matchers, scoring

    noise = 0.03
    occ, origin, scale = datagen.cecum_world()
    lap = datagen.rectangle_trajectory(step=0.3)
    bearings = datagen.default_bearings(90)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, jnp.tile(lap, (2, 1)), bearings,
        jax.random.PRNGKey(1), odom_noise_xy=noise, odom_noise_theta=noise * 0.6,
    )
    sc = scoring.ScoringConfig(reducer="overlap", window=1)
    mc = matchers.MonteCarloConfig(sigma_xy=0.1, sigma_theta=0.06, batch=24,
                                   rounds=8, scoring=sc)

    cfg1 = dataclasses.replace(tiny.tiny_config(map_size=192), matcher_cfg=mc)
    e1 = eng.Engine(cfg1)
    e1.state = e1.state.replace(pose=gt[0])
    traj1, _ = e1.run(scans, odom)
    tiny_ate = float(evaluate.ate(traj1, gt, align=False))

    cfgp = gmapping.GMappingConfig(
        n_particles=24, map_height=192, map_width=192, matcher_cfg=mc,
        proposal="improved", resample_threshold=0.8, weight_gamma=16.0,
        noise_xy=noise, noise_theta=noise * 0.6,
    )
    st = gmapping.init_state(cfgp, jax.random.PRNGKey(101)).replace(
        poses=jnp.broadcast_to(gt[0], (24, 3))
    )
    stf, traj, _, all_poses, anc = gmapping.run_sequence(cfgp, st, scans, odom)
    win = gmapping.winner_trajectory(all_poses, anc, gmapping.best_particle(stf))
    rbpf_ate = float(evaluate.ate(win, gt, align=False))

    assert tiny_ate > 0.4, f"noise regime too easy: tiny ATE {tiny_ate}"
    assert rbpf_ate < 0.6 * tiny_ate, (rbpf_ate, tiny_ate)
