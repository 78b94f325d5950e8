"""Distributed-equivalence tests on the 8-device CPU mesh (SURVEY.md §4:
sharded == unsharded golden tests; halo correctness at shard boundaries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.models import gmapping, posegraph as pg
from slam_constructor_tpu.ops import cells, grid, raycast, resample, scoring
from slam_constructor_tpu.parallel import dist_ba, halo, mesh as meshlib, particles
from slam_constructor_tpu.utils import datagen

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_psum_normalize_matches_local():
    m = meshlib.flat_mesh("particles")
    logw = jax.random.normal(jax.random.PRNGKey(0), (32,)) * 3.0
    got = particles.psum_normalize_log_weights(logw, m)
    want = resample.normalize_log_weights(logw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_sharded_neff_matches_local():
    m = meshlib.flat_mesh("particles")
    logw = jax.random.normal(jax.random.PRNGKey(1), (16,))
    got = float(particles.sharded_neff(logw, m))
    want = float(resample.effective_sample_size(logw))
    assert got == pytest.approx(want, rel=1e-5)


def test_sharded_gmapping_step_matches_unsharded():
    occ, origin, scale = datagen.cecum_world()
    bearings = datagen.default_bearings(60)
    poses = datagen.corridor_trajectory(4)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(2)
    )
    cfg = gmapping.GMappingConfig(n_particles=8, map_height=96, map_width=96)
    st = gmapping.init_state(cfg)
    s0 = jax.tree.map(lambda a: a[0], scans)

    ref, _ = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg, s, sc, od))(
        st, s0, odom[0]
    )

    m = meshlib.flat_mesh("particles")
    step = particles.make_sharded_step(cfg, m)
    st2 = gmapping.init_state(cfg)
    st2 = particles.shard_state(st2, m)
    got, _ = step(st2, s0, odom[0])

    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(ref.poses), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(got.log_weights), np.asarray(ref.log_weights), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.gm.cells), np.asarray(ref.gm.cells), atol=1e-5
    )


@pytest.mark.parametrize("reducer", ["obstacle", "max", "mean", "overlap"])
def test_halo_sharded_score_matches_unsharded(reducer):
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=6)
    bearings = datagen.default_bearings(120)
    true_pose = jnp.array([0.2, 0.1, 0.3])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    gm = raycast.insert_scan(gm, model, true_pose, s, raycast.BeamConfig())
    view = scoring.MapView.of(gm, model)
    cfg = scoring.ScoringConfig(reducer=reducer, window=1)

    # candidates deliberately spread so endpoints hit every shard boundary
    key = jax.random.PRNGKey(3)
    cand = true_pose[None, :] + jax.random.normal(key, (16, 3)) * jnp.array(
        [0.5, 2.0, 0.2]
    )
    want = scoring.score_poses(view, s, cand, cfg)

    m = meshlib.flat_mesh("chips")
    got = halo.sharded_score_poses(view, s, cand, cfg, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_distributed_optimize_matches_local():
    import tests.test_posegraph as tpg

    st, gt = tpg._circle_graph(n=12, drift=0.06, seed=5)
    cfg = tpg.CFG
    local = pg.optimize(cfg, st)

    m = meshlib.flat_mesh("hosts")
    dist = dist_ba.distributed_optimize(cfg, st, m)
    np.testing.assert_allclose(
        np.asarray(dist.kf_poses), np.asarray(local.kf_poses), atol=1e-3
    )


def test_distributed_optimize_schur_matches_direct():
    import tests.test_posegraph as tpg

    st, gt = tpg._circle_graph(n=10, drift=0.05, seed=6)
    cfg = tpg.CFG
    m = meshlib.flat_mesh("hosts")
    direct = dist_ba.distributed_optimize(cfg, st, m)
    schur = dist_ba.distributed_optimize(cfg, st, m, schur_split=8)
    np.testing.assert_allclose(
        np.asarray(schur.kf_poses), np.asarray(direct.kf_poses), atol=1e-3
    )


def test_hosts_chips_mesh():
    m = meshlib.make_mesh(n_hosts=2, n_chips=4)
    assert m.shape == {"hosts": 2, "chips": 4}


@pytest.mark.parametrize("reducer", ["obstacle", "mean", "overlap"])
def test_beam_sharded_score_matches_unsharded(reducer):
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=6)
    bearings = datagen.default_bearings(120)
    true_pose = jnp.array([0.2, 0.1, 0.3])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    gm = raycast.insert_scan(gm, model, true_pose, s, raycast.BeamConfig())
    view = scoring.MapView.of(gm, model)
    cfg = scoring.ScoringConfig(reducer=reducer, window=1)
    cand = true_pose[None, :] + jax.random.normal(
        jax.random.PRNGKey(5), (8, 3)
    ) * jnp.array([0.4, 0.4, 0.2])
    want = scoring.score_poses(view, s, cand, cfg)
    m = meshlib.flat_mesh("chips")
    got = halo.beam_sharded_score_poses(view, s, cand, cfg, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


# --- region-sharded block-pool map (parallel/blockshard.py) -----------------


def _blockshard_fixture(n_scans=3):
    """Same scans inserted into an unsharded BlockMap and a sharded one."""
    from slam_constructor_tpu.ops import blockmap
    from slam_constructor_tpu.parallel import blockshard

    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=7)
    bearings = datagen.default_bearings(90)
    model = cells.BayesAvgCell()
    beam = raycast.BeamConfig()
    m = meshlib.flat_mesh("chips")
    n_dev = len(jax.devices())

    bm = blockmap.make_block_map(
        model, tiles_h=8, tiles_w=8, capacity=64, block=16, scale=0.1,
        origin=(-6.4, -6.4),
    )
    sbm = blockshard.make_sharded_block_map(
        model, tiles_h=8, tiles_w=8, capacity_per_shard=16, n_shards=n_dev,
        block=16, scale=0.1, origin=(-6.4, -6.4),
    )
    scans, poses = [], []
    for i in range(n_scans):
        p = jnp.array([0.3 * i - 0.3, 0.2 * i, 0.4 * i])
        s = raycast.cast_rays(occ, origin, scale, p, bearings)
        bm = blockmap.insert_scan(bm, model, p, s, beam)
        sbm = blockshard.insert_scan(sbm, model, p, s, beam, m)
        scans.append(s)
        poses.append(p)
    return bm, sbm, model, m, scans, poses


def test_blockshard_insert_matches_unsharded_plane():
    from slam_constructor_tpu.ops import blockmap
    from slam_constructor_tpu.parallel import blockshard

    bm, sbm, model, m, _, _ = _blockshard_fixture()
    gm = blockmap.extract_window(
        bm, model, jnp.zeros(2), bm.table.shape[0], bm.table.shape[1]
    )
    want = jnp.where(grid.known_mask(gm), grid.occupancy_plane(gm, model), 0.5)
    got = blockshard.gather_value_plane(sbm, model, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    # blocks live on the band owners: every band with content allocated some
    assert int(sbm.n_alloc.sum()) == int(bm.n_alloc)
    assert not bool(sbm.overflowed)


@pytest.mark.parametrize("reducer", ["obstacle", "max", "mean", "overlap"])
def test_blockshard_score_matches_unsharded(reducer):
    from slam_constructor_tpu.ops import blockmap
    from slam_constructor_tpu.parallel import blockshard

    bm, sbm, model, m, scans, poses = _blockshard_fixture()
    gm = blockmap.extract_window(
        bm, model, jnp.zeros(2), bm.table.shape[0], bm.table.shape[1]
    )
    view = scoring.MapView.of(gm, model)
    cfg = scoring.ScoringConfig(reducer=reducer, window=1, impl="gather")
    # candidates spread across shard-boundary rows
    cand = poses[-1][None, :] + jax.random.normal(
        jax.random.PRNGKey(9), (16, 3)
    ) * jnp.array([0.4, 2.0, 0.2])
    want = scoring.score_poses(view, scans[-1], cand, cfg)
    got = blockshard.score_poses(sbm, model, scans[-1], cand, cfg, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_blockshard_jit_and_sharding_specs():
    """insert + score compile under jit with explicit device placement."""
    from slam_constructor_tpu.parallel import blockshard

    model = cells.BayesAvgCell()
    m = meshlib.flat_mesh("chips")
    n_dev = len(jax.devices())
    sbm = blockshard.make_sharded_block_map(
        model, tiles_h=8, tiles_w=8, capacity_per_shard=8, n_shards=n_dev,
        block=16, scale=0.1,
    )
    sbm = blockshard.place(sbm, m)
    occ, origin, scale = datagen.cecum_world()
    bearings = datagen.default_bearings(60)
    p = jnp.zeros(3)
    s = raycast.cast_rays(occ, origin, scale, p, bearings)
    beam = raycast.BeamConfig()
    step = jax.jit(
        lambda st, pose, sc: blockshard.insert_scan(st, model, pose, sc, beam, m)
    )
    sbm = step(sbm, p, s)
    sbm = step(sbm, p + jnp.array([0.1, 0.0, 0.05]), s)
    cfg = scoring.ScoringConfig(reducer="mean", window=1)
    probs = jax.jit(
        lambda st, sc, cand: blockshard.score_poses(st, model, sc, cand, cfg, m)
    )(sbm, s, p[None, :] + jnp.zeros((4, 3)))
    assert probs.shape == (4,)
    assert bool(jnp.isfinite(probs).all())


# --- EP-sharded CoW particle pools (parallel/ep_cow.py) ----------------------


def test_ep_cow_matches_single_device():
    """Per-device CoW pools == the single shared-pool CoW map through
    insert -> cross-shard resample -> insert (write-after-migration)."""
    from slam_constructor_tpu.ops import cow
    from slam_constructor_tpu.parallel import ep_cow

    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=8)
    bearings = datagen.default_bearings(60)
    model = cells.BayesAvgCell()
    beam = raycast.BeamConfig()
    m = meshlib.flat_mesh("chips")
    n_dev = len(jax.devices())
    p = n_dev  # 1 particle per shard: every resample crosses devices

    # the shared pool needs capacity for EVERY particle's distinct blocks
    # (~31 tiles x 8 particles + CoW copies); the EP pools each hold one
    # particle's — the capacity-scaling advantage of per-device pools
    single = cow.make_cow_maps(model, p, 6, 6, capacity=768, block=16, scale=0.1)
    ep = ep_cow.make_ep_maps(
        model, p, 6, 6, capacity_per_shard=96, n_shards=n_dev,
        block=16, scale=0.1,
    )
    ep = ep_cow.place(ep, m)

    def observations(poses):
        rows, cols, w, s = jax.vmap(
            lambda pose: raycast.scan_sample_cells(
                single.origin, single.scale, pose, scan, beam
            )
        )(poses)
        pid = jnp.broadcast_to(jnp.arange(p)[:, None], rows.shape)
        return (pid.ravel(), rows.ravel(), cols.ravel(), w.ravel(), s.ravel())

    def single_insert(st, pid, rows, cols, w, s):
        b = st.block
        th, tw = st.tables.shape[1:]
        tr = jnp.clip(rows // b, 0, th - 1)
        tc = jnp.clip(cols // b, 0, tw - 1)
        ok = (w > 0) & (rows >= 0) & (rows < th * b) & (cols >= 0) & (cols < tw * b)
        touched = jnp.zeros((p, th, tw), bool).at[pid, tr, tc].max(ok, mode="drop")
        st = cow.prepare_write(st, model, touched)
        return cow.scatter_observations(st, model, pid, rows, cols, w, s)

    def single_planes(st):
        def one(i):
            gm = cow.extract_window(st, model, i, jnp.zeros(2), 6, 6)
            return jnp.where(
                grid.known_mask(gm), grid.occupancy_plane(gm, model), 0.5
            )
        return jax.vmap(one)(jnp.arange(p))

    poses = jnp.stack(
        [jnp.array([0.2 * i - 0.5, 0.1 * i, 0.3 * i]) for i in range(p)]
    )
    scan = raycast.cast_rays(occ, origin, scale, poses[0], bearings)

    obs = observations(poses)
    single = single_insert(single, *obs)
    ep = ep_cow.ep_insert(ep, model, *obs, m)
    np.testing.assert_allclose(
        np.asarray(ep_cow.gather_planes(ep, model, m)),
        np.asarray(single_planes(single)), atol=1e-5,
    )

    # cross-shard ancestry: particle 0's map survives everywhere + a swap
    idx = jnp.array([0] * (p - 2) + [p - 1, p - 2], jnp.int32)
    single = cow.resample(single, idx)
    ep = ep_cow.ep_resample(ep, idx, m)
    np.testing.assert_allclose(
        np.asarray(ep_cow.gather_planes(ep, model, m)),
        np.asarray(single_planes(single)), atol=1e-5,
    )
    assert not bool(np.asarray(ep.overflow).any())

    # write after migration: CoW must copy shared blocks correctly
    poses2 = poses + jnp.array([0.15, -0.1, 0.05])
    obs2 = observations(poses2)
    single = single_insert(single, *obs2)
    ep = ep_cow.ep_insert(ep, model, *obs2, m)
    np.testing.assert_allclose(
        np.asarray(ep_cow.gather_planes(ep, model, m)),
        np.asarray(single_planes(single)), atol=1e-5,
    )


@pytest.mark.parametrize("proposal", ["odom", "improved"])
def test_ep_gmapping_step_matches_unsharded_cow(proposal):
    """Full EP RBPF step (per-device pools) == single shared-pool cow step:
    same keys -> same trajectories, weights, and per-particle occupancy.
    Parametrized over BOTH proposals (round-3 verdict task 5: the sharded
    steps must support the improved proposal, not guard it away); the
    improved variant also exercises the minimumScore gate."""
    from slam_constructor_tpu.ops import cow
    from slam_constructor_tpu.parallel import ep_cow

    occ, origin, scale = datagen.cecum_world()
    bearings = datagen.default_bearings(60)
    poses = datagen.corridor_trajectory(4)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(11)
    )
    n_dev = len(jax.devices())
    cfg = gmapping.GMappingConfig(
        n_particles=n_dev, map_height=96, map_width=96, map_storage="cow",
        tile_block=16, tile_capacity=1024, window_tiles=4,
        proposal=proposal,
        min_match_prob=0.3 if proposal == "improved" else 0.0,
    )
    m = meshlib.flat_mesh("chips")

    ref = gmapping.init_state(cfg)
    step_ref = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg, s, sc, od))

    st = ep_cow.init_ep_state(cfg, n_dev, capacity_per_shard=192)
    st = st.replace(gm=ep_cow.place(st.gm, m))
    step_ep = ep_cow.make_ep_step(cfg, m)

    for i in range(3):
        s_i = jax.tree.map(lambda a: a[i], scans)
        ref, idx_ref = step_ref(ref, s_i, odom[i])
        st, idx_ep = step_ep(st, s_i, odom[i])
        np.testing.assert_array_equal(np.asarray(idx_ep), np.asarray(idx_ref))

    np.testing.assert_allclose(
        np.asarray(st.poses), np.asarray(ref.poses), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.log_weights), np.asarray(ref.log_weights), atol=1e-5
    )

    def ref_planes(cm):
        th, tw = cm.tables.shape[1:]
        def one(i):
            gm = cow.extract_window(cm, cfg.cell_model, i, jnp.zeros(2), th, tw)
            return jnp.where(
                grid.known_mask(gm), grid.occupancy_plane(gm, cfg.cell_model), 0.5
            )
        return jax.vmap(one)(jnp.arange(cfg.n_particles))

    np.testing.assert_allclose(
        np.asarray(ep_cow.gather_planes(st.gm, cfg.cell_model, m)),
        np.asarray(ref_planes(ref.gm)), atol=1e-5,
    )


@pytest.mark.parametrize("reducer", ["obstacle", "mean", "overlap"])
def test_halo_sharded_matmul_matches_unsharded_matmul(reducer):
    """The one-hot matmul sampling path inside shard_map (impl='matmul';
    'auto' is the gather) must equal the unsharded matmul scorer."""
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=6)
    bearings = datagen.default_bearings(120)
    true_pose = jnp.array([0.2, 0.1, 0.3])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 80, 80, 0.1)
    gm = raycast.insert_scan(gm, model, true_pose, s, raycast.BeamConfig())
    view = scoring.MapView.of(gm, model)
    cfg = scoring.ScoringConfig(reducer=reducer, window=1, impl="matmul")

    key = jax.random.PRNGKey(3)
    cand = true_pose[None, :] + jax.random.normal(key, (16, 3)) * jnp.array(
        [0.5, 2.0, 0.2]  # spread across shard boundaries and off-map
    )
    want = scoring.score_poses(view, s, cand, cfg)
    m = meshlib.flat_mesh("chips")
    got = halo.sharded_score_poses(view, s, cand, cfg, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("reducer", ["obstacle", "overlap"])
def test_blockshard_matmul_matches_unsharded_matmul(reducer):
    """Region-sharded block-map scoring with the forced matmul sampling path ==
    dense matmul scoring of the same content."""
    from slam_constructor_tpu.parallel import blockshard as bs

    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=4, seed=8)
    bearings = datagen.default_bearings(90)
    true_pose = jnp.array([0.1, -0.2, 0.4])
    s = raycast.cast_rays(occ, origin, scale, true_pose, bearings)
    model = cells.BayesAvgCell()
    m = meshlib.flat_mesh("chips")
    n_dev = m.shape["chips"]
    sbm = bs.make_sharded_block_map(
        model, tiles_h=8, tiles_w=8, capacity_per_shard=16, n_shards=n_dev,
        block=16, scale=0.1,
    )
    sbm = bs.insert_scan(sbm, model, true_pose, s, raycast.BeamConfig(), m)
    cfg = scoring.ScoringConfig(reducer=reducer, window=1, impl="matmul")
    key = jax.random.PRNGKey(5)
    cand = true_pose[None, :] + jax.random.normal(key, (12, 3)) * jnp.array(
        [0.4, 1.5, 0.2]
    )
    got = bs.score_poses(sbm, model, s, cand, cfg, m)

    plane = bs.gather_value_plane(sbm, model, m, unknown_prob=cfg.unknown_prob)
    dense_view = scoring.MapView(
        occ=plane, known=jnp.ones_like(plane, bool), origin=sbm.origin,
        scale=sbm.scale,
    )
    want = scoring.score_poses(dense_view, s, cand, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


# --- EP x TP composed mesh (parallel/ep2d.py) --------------------------------


def _mesh_2d(n_pgroups, n_bands):
    devs = np.asarray(jax.devices()[: n_pgroups * n_bands]).reshape(
        n_pgroups, n_bands
    )
    from jax.sharding import Mesh

    return Mesh(devs, ("pgroups", "bands"))


@pytest.mark.parametrize("shape,proposal", [
    ((2, 4), "odom"), ((4, 2), "odom"), ((2, 4), "improved"),
])
def test_ep2d_gmapping_step_matches_unsharded_cow(shape, proposal):
    """Full RBPF step on the composed (pgroups x bands) mesh == the
    single-device shared-pool CoW step: same keys -> identical resample
    indices, poses, weights, and per-particle occupancy planes (the EP x TP
    composition golden, for both proposals)."""
    from slam_constructor_tpu.ops import cow
    from slam_constructor_tpu.parallel import ep2d

    occ, origin, scale = datagen.cecum_world()
    bearings = datagen.default_bearings(60)
    poses = datagen.corridor_trajectory(4)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(11)
    )
    n_pg, n_b = shape
    cfg = gmapping.GMappingConfig(
        n_particles=2 * n_pg, map_height=128, map_width=128,
        map_storage="cow", tile_block=16, tile_capacity=1024, window_tiles=4,
        proposal=proposal,
        min_match_prob=0.3 if proposal == "improved" else 0.0,
    )
    m = _mesh_2d(n_pg, n_b)

    ref = gmapping.init_state(cfg)
    step_ref = jax.jit(lambda s, sc, od: gmapping.gmapping_step(cfg, s, sc, od))

    st = ep2d.init_ep2d_state(cfg, n_pg, n_b, capacity_per_device=192)
    st = st.replace(gm=ep2d.place(st.gm, m))
    step_2d = ep2d.make_ep2d_step(cfg, m)

    for i in range(3):
        s_i = jax.tree.map(lambda a: a[i], scans)
        ref, idx_ref = step_ref(ref, s_i, odom[i])
        st, idx_2d = step_2d(st, s_i, odom[i])
        np.testing.assert_array_equal(np.asarray(idx_2d), np.asarray(idx_ref))

    np.testing.assert_allclose(
        np.asarray(st.poses), np.asarray(ref.poses), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.log_weights), np.asarray(ref.log_weights), atol=1e-5
    )

    from slam_constructor_tpu.ops import cow as cowlib

    def ref_planes(cm):
        th, tw = cm.tables.shape[1:]

        def one(i):
            gm = cowlib.extract_window(cm, cfg.cell_model, i, jnp.zeros(2), th, tw)
            return jnp.where(
                grid.known_mask(gm), grid.occupancy_plane(gm, cfg.cell_model), 0.5
            )

        return jax.vmap(one)(jnp.arange(cfg.n_particles))

    np.testing.assert_allclose(
        np.asarray(ep2d.gather_planes(st.gm, cfg.cell_model, m)),
        np.asarray(ref_planes(ref.gm)), atol=1e-5,
    )
    assert not bool(np.asarray(st.gm.overflow).any())
