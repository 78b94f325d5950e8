"""Full pipeline (BASELINE config[3]): drive a loop around the cecum inner
block with drifting odometry; the pose graph must detect the loop closure on
return and cut the accumulated trajectory error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.models import full, posegraph as pg, tiny
from slam_constructor_tpu.ops import grid as gridlib, matchers, scoring
from slam_constructor_tpu.utils import datagen, evaluate


@pytest.fixture(scope="module")
def loop_sequence():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.35)
    # sanity: every pose sits in free space of the ground-truth world
    col = np.floor((np.asarray(poses)[:, 0] - float(origin[0])) / scale).astype(int)
    row = np.floor((np.asarray(poses)[:, 1] - float(origin[1])) / scale).astype(int)
    assert np.asarray(occ)[row, col].max() == 0.0, "trajectory hits a wall"
    bearings = datagen.default_bearings(120)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(5),
        odom_noise_xy=0.02, odom_noise_theta=0.012,
    )
    return scans, odom, gt


def make_engine(n_beams):
    graph = pg.PoseGraphConfig(
        max_keyframes=64,
        max_edges=256,
        keyframe_distance=0.7,
        loop_radius=2.0,
        min_index_gap=8,
        min_prob=0.55,
        max_candidates=4,
        local_map_size=120,
        gn_iterations=12,
    )
    cfg = full.FullConfig(
        tracking=tiny.tiny_config(map_size=192, mc_batch=32, mc_rounds=10),
        graph=graph,
    )
    return full.FullSlamEngine(cfg, n_beams=n_beams)


def test_full_pipeline_closes_loop(loop_sequence):
    scans, odom, gt = loop_sequence
    e = make_engine(scans.ranges.shape[1])
    e.state = e.state.replace(pose=gt[0])
    traj = e.run(scans, odom)

    assert int(e.graph.n_kf) >= 5, "keyframes were not added"
    assert e.total_loops >= 1, "no loop closures detected on a closed loop"

    # loop closure must snap the live pose back onto ground truth at the
    # end of the lap, even though drift peaked mid-loop (online trajectory
    # history is not retro-corrected, so full-run ATE stays loose)
    final_err = float(jnp.linalg.norm(traj[-1, :2] - gt[-1, :2]))
    peak_err = float(jnp.linalg.norm(traj[:, :2] - gt[:, :2], axis=1).max())
    assert final_err < 0.3, f"final error {final_err} (peak {peak_err})"
    assert final_err < peak_err / 2, "closure did not reduce drift"
    assert float(evaluate.ate(traj, gt, align=False)) < 1.5

    # keyframe graph after optimization stays consistent
    assert float(pg.graph_error(e.graph)) < 1e3


def test_full_pipeline_map_regenerated(loop_sequence):
    scans, odom, gt = loop_sequence
    e = make_engine(scans.ranges.shape[1])
    e.state = e.state.replace(pose=gt[0])
    e.run(scans, odom)
    occ = np.asarray(e.occupancy)
    assert (occ > 0.6).sum() > 100  # walls present after regen


def test_full_pipeline_checkpoint_resume(loop_sequence, tmp_path):
    """Mid-run checkpoint -> resume must reproduce the uninterrupted run
    bit-exactly: device pytrees AND host anchor/counter state round-trip
    (SURVEY.md §5 checkpoint/resume, extended to the full pipeline)."""
    scans, odom, gt = loop_sequence
    import numpy as np

    def make():
        e = make_engine(n_beams=120)
        e.state = e.state.replace(pose=gt[0])
        return e

    n = int(odom.shape[0])
    half = n // 2

    ref = make()
    ref.run(scans, odom, segment=32)
    want = np.asarray(ref.corrected_trajectory())

    a = make()
    a.run(jax.tree.map(lambda x: x[:half], scans), odom[:half], segment=32)
    a.save_checkpoint(str(tmp_path / "ck"))

    b = make()
    b.restore_checkpoint(str(tmp_path / "ck"))
    b.run(jax.tree.map(lambda x: x[half:], scans), odom[half:], segment=32)
    got = np.asarray(b.corrected_trajectory())

    np.testing.assert_array_equal(got, want)
    assert b.total_loops == ref.total_loops


def test_full_pipeline_tbm_tracking(loop_sequence):
    """The fused segment with a NON-additive cell model (TBM): submap
    rendering and map regeneration take the sequential-fold path inside
    the same program (cells.fold_additive gate) and the pipeline still
    closes loops and beats odometry."""
    from slam_constructor_tpu.models import viny

    scans, odom, gt = loop_sequence
    graph = pg.PoseGraphConfig(
        max_keyframes=64, max_edges=256, keyframe_distance=0.7,
        loop_radius=2.0, min_index_gap=8, min_prob=0.55, max_candidates=4,
        local_map_size=120, gn_iterations=12,
    )
    e = full.FullSlamEngine(
        full.FullConfig(
            tracking=viny.viny_config(map_size=192, mc_batch=32, mc_rounds=10),
            graph=graph,
        ),
        n_beams=120,
    )
    e.state = e.state.replace(pose=gt[0])
    traj = e.run(scans, odom, segment=32)
    ate = float(evaluate.ate(traj, gt[: traj.shape[0]], align=False))
    assert e.total_loops > 0, "no loop closures with TBM tracking"
    assert ate < 0.25, f"TBM full pipeline ATE {ate}"


def test_graph_does_not_degrade_accurate_tracking():
    """Regression: with the earlier graph defaults the pose
    graph DOUBLED the ATE of an already-sub-cell-accurate tracker on the
    2-lap 360-beam bench (0.141 vs 0.071, seed 42) — curvature-estimated
    loop information was allowed 10x the calibrated baseline and the
    Huber kernel never engaged, so the optimizer dragged keyframes to
    BF-grid-quantized loop deltas. The graph must be (at worst) neutral
    when tracking is already good; 360 beams matters — at 120 beams the
    effect is invisible, which is how it went unnoticed."""
    occ, origin, scale = datagen.cecum_world()
    lap = datagen.rectangle_trajectory(step=0.3)
    posesq = jnp.tile(lap, (2, 1))
    bearings = datagen.default_bearings(360)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, posesq, bearings, jax.random.PRNGKey(42),
        odom_noise_xy=0.01, odom_noise_theta=0.005,
    )
    from slam_constructor_tpu.models import engine as eng

    tracking = tiny.tiny_config(map_size=256)
    st = eng.init_state(tracking)
    st = st.replace(pose=gt[0])
    _, traj_t, _ = eng.run_sequence(tracking, st, scans, odom)
    ate_t = float(evaluate.ate(traj_t, gt, align=False))

    g = pg.PoseGraphConfig(
        keyframe_distance=0.7, min_index_gap=8, max_candidates=4,
        local_map_size=120,
    )
    e = full.FullSlamEngine(
        full.FullConfig(tracking=tiny.tiny_config(map_size=256), graph=g,
                        optimize_every_loops=1),
        n_beams=360,
    )
    e.state = e.state.replace(pose=gt[0])
    traj_f = e.run(scans, odom, segment=posesq.shape[0])
    ate_f = float(evaluate.ate(traj_f, gt[: traj_f.shape[0]], align=False))

    assert e.total_loops > 50, "bench should close loops densely"
    assert ate_f <= 1.3 * ate_t, (
        f"graph degraded tracking: full {ate_f} vs tracker-only {ate_t}"
    )
