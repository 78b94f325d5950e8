"""Config system, dataset reader (native + python), checkpointing, metrics."""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu.models import engine as eng
from slam_constructor_tpu.ops import cells
from slam_constructor_tpu.utils import checkpoint, config, dataset, metrics, profiling


# --- config -----------------------------------------------------------------


def test_parse_properties():
    text = textwrap.dedent(
        """
        # comment
        cell.model = tbm
        matcher.type = hill_climbing
        map.scale = 0.05
        scoring.reducer = mean
        """
    )
    p = config.parse_properties(text)
    assert p["cell.model"] == "tbm"
    assert p["map.scale"] == "0.05"


def test_engine_config_from_properties():
    p = {
        "cell.model": "tbm",
        "cell.quality": "0.6",
        "matcher.type": "hill_climbing",
        "matcher.iterations": "20",
        "map.height": "128",
        "map.scale": "0.05",
        "scoring.reducer": "mean",
        "scoring.window": "2",
        "beam.occupancy_estimator": "area",
        "engine.use_angle_histogram": "true",
    }
    cfg = config.engine_config_from(p)
    assert isinstance(cfg.cell_model, cells.TBMCell)
    assert cfg.cell_model.quality == 0.6
    assert cfg.matcher == "hill_climbing"
    assert cfg.matcher_cfg.iterations == 20
    assert cfg.matcher_cfg.scoring.reducer == "mean"
    assert cfg.matcher_cfg.scoring.window == 2
    assert cfg.map_height == 128 and cfg.map_scale == 0.05
    assert cfg.beam.occupancy_estimator == "area"
    assert cfg.use_angle_histogram
    eng.init_state(cfg)  # constructible


def test_gmapping_config_from_properties():
    cfg = config.gmapping_config_from({"pf.particles": "12", "matcher.type": "monte_carlo"})
    assert cfg.n_particles == 12


def test_all_presets_exist():
    for name in config.PRESETS:
        assert config.preset(name) is not None


def test_matcher_m3rsm_selectable():
    cfg = config.engine_config_from({"matcher.type": "m3rsm", "matcher.n_theta": "9"})
    assert cfg.matcher == "m3rsm"
    assert cfg.matcher_cfg.n_theta == 9


# --- dataset ----------------------------------------------------------------

CARMEN_SAMPLE = """# carmen log
PARAM robot_frontlaser_offset 0.0
FLASER 4 1.0 2.0 3.0 4.0 0.1 0.2 0.05 0.11 0.21 0.06 100.5 host 100.5
FLASER 4 1.1 2.1 3.1 4.1 0.2 0.3 0.06 0.21 0.31 0.07 100.6 host 100.6
ODOM 0.0 0.0 0.0 0.5 0.0 0.0 100.55 host 100.55
FLASER 4 1.2 2.2 3.2 4.2 0.3 0.4 0.07 0.31 0.41 0.08 100.7 host 100.7
"""


@pytest.fixture
def carmen_file(tmp_path):
    p = tmp_path / "sample.clf"
    p.write_text(CARMEN_SAMPLE)
    return str(p)


def test_read_carmen_python(carmen_file):
    log = dataset._read_carmen_py(carmen_file)
    assert log.ranges.shape == (3, 4)
    np.testing.assert_allclose(log.ranges[0], [1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(log.odom_poses[1], [0.21, 0.31, 0.07], atol=1e-9)
    np.testing.assert_allclose(log.timestamps, [100.5, 100.6, 100.7])


def test_read_carmen_native_matches_python(carmen_file):
    lib = dataset.native_lib()
    if lib is None:
        pytest.skip("no C++ toolchain")
    nat = dataset.read_carmen(carmen_file, prefer_native=True)
    py = dataset._read_carmen_py(carmen_file)
    np.testing.assert_allclose(nat.ranges, py.ranges)
    np.testing.assert_allclose(nat.odom_poses, py.odom_poses)
    np.testing.assert_allclose(nat.timestamps, py.timestamps)


def test_to_sequence(carmen_file):
    log = dataset.read_carmen(carmen_file)
    scans, odom, ts = dataset.to_sequence(log, max_range=3.5)
    assert scans.ranges.shape == (3, 4)
    # ranges 4.0+ filtered by max_range
    assert not bool(scans.valid[0, 3])
    assert bool(scans.valid[0, 1])
    np.testing.assert_allclose(np.asarray(odom[0]), 0.0)
    assert odom.shape == (3, 3)


# --- checkpoint -------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    from slam_constructor_tpu.models import tiny

    cfg = tiny.tiny_config(map_size=64)
    st = eng.init_state(cfg)
    st = st.replace(pose=jnp.array([1.0, 2.0, 0.3]), step=jnp.int32(7))
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, st)
    st2 = checkpoint.restore(path, eng.init_state(cfg))
    assert float(st2.pose[0]) == 1.0
    assert int(st2.step) == 7
    np.testing.assert_array_equal(np.asarray(st2.gm.cells), np.asarray(st.gm.cells))


def test_checkpoint_structure_mismatch(tmp_path):
    from slam_constructor_tpu.models import gmapping, tiny

    cfg = tiny.tiny_config(map_size=64)
    st = eng.init_state(cfg)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, st)
    other = gmapping.init_state(gmapping.GMappingConfig(n_particles=2, map_height=64, map_width=64))
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, other)


def test_checkpoint_resume_determinism(tmp_path):
    """Resume must be bit-reproducible (SURVEY.md §5)."""
    from slam_constructor_tpu.models import tiny
    from slam_constructor_tpu.utils import datagen

    occ, origin, scale = datagen.cecum_world()
    poses = datagen.corridor_trajectory(6)
    bearings = datagen.default_bearings(60)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(1)
    )
    cfg = tiny.tiny_config(map_size=96, mc_batch=8, mc_rounds=4)
    step = jax.jit(lambda s, sc, od: eng.slam_step(cfg, s, sc, od))

    st = eng.init_state(cfg)
    for i in range(3):
        st = step(st, jax.tree.map(lambda a: a[i], scans), odom[i])
    path = str(tmp_path / "mid.npz")
    checkpoint.save(path, st)
    for i in range(3, 6):
        st = step(st, jax.tree.map(lambda a: a[i], scans), odom[i])

    st2 = checkpoint.restore(path, eng.init_state(cfg))
    for i in range(3, 6):
        st2 = step(st2, jax.tree.map(lambda a: a[i], scans), odom[i])
    np.testing.assert_array_equal(np.asarray(st.pose), np.asarray(st2.pose))
    np.testing.assert_array_equal(np.asarray(st.gm.cells), np.asarray(st2.gm.cells))


# --- metrics / profiling ----------------------------------------------------


def test_metrics_logger(tmp_path):
    m = metrics.MetricsLogger()
    for i in range(5):
        m.log(i, prob=0.5 + i / 10, neff=8 - i)
    s = m.summary()
    assert s["prob"]["last"] == pytest.approx(0.9)
    p = str(tmp_path / "metrics.jsonl")
    m.save_jsonl(p)
    m2 = metrics.MetricsLogger.load_jsonl(p)
    assert len(m2.rows) == 5


def test_sol_report():
    spec = profiling.device_specs("NVIDIA H100 80GB HBM3")
    r = profiling.sol_report(
        "score", measured_s=1e-3, flops=1e9, bytes_accessed=1e7, spec=spec
    )
    assert 0 < r["sol_fraction"] <= 1e3
    assert r["bound"] in ("compute", "memory")
    assert r["device"] == "h100_sxm"


@pytest.mark.parametrize(
    "kind,name,bf16,f32,hbm",
    [
        ("NVIDIA H100 80GB HBM3", "h100_sxm", 989e12, 67e12, 3.35e12),
        ("NVIDIA H100 PCIe", "h100_pcie", 756e12, 51e12, 2.0e12),
    ],
)
def test_device_specs_h100(kind, name, bf16, f32, hbm):
    spec = profiling.device_specs(kind)
    assert (spec.name, spec.peak_flops_bf16, spec.peak_flops_f32,
            spec.hbm_bandwidth) == (name, bf16, f32, hbm)


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_device_specs_unknown_kind_raises(kind):
    """A device with no published-peak row is an error, never a default:
    a roofline share against a guessed peak would be meaningless."""
    with pytest.raises(KeyError):
        profiling.device_specs(kind)


def test_device_info_names_the_backend():
    info = profiling.device_info()
    assert info == {
        "platform": "cpu",
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    from slam_constructor_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    from slam_constructor_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a, b = compile_cache.cache_dir(), compile_cache.cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert a == b == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_step_timer():
    t = profiling.StepTimer()
    for _ in range(3):
        with t:
            pass
    assert t.summary()["steps"] == 3


def test_same_seed_bitwise_reproducibility():
    """Two identical runs produce bit-identical trajectories and maps
    (deterministic reductions + explicit PRNG threading — SURVEY.md §5)."""
    from slam_constructor_tpu.models import tiny
    from slam_constructor_tpu.utils import datagen

    occ, origin, scale = datagen.cecum_world()
    poses = datagen.corridor_trajectory(8)
    bearings = datagen.default_bearings(60)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(5)
    )
    outs = []
    for _ in range(2):
        e = tiny.make_engine(map_size=96, mc_batch=16, mc_rounds=6)
        e.state = e.state.replace(pose=gt[0])
        traj, _ = e.run(scans, odom)
        outs.append((np.asarray(traj), np.asarray(e.state.gm.cells)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_refine_config_from_properties():
    from slam_constructor_tpu.utils import config as cfglib

    p = cfglib.parse_properties(
        "matcher.type = monte_carlo\n"
        "refine.type = gradient\n"
        "refine.iterations = 8\n"
        "refine.step_xy = 0.03\n"
    )
    cfg = cfglib.engine_config_from(p)
    assert cfg.refine_matcher == "gradient"
    assert cfg.refine_cfg.iterations == 8
    assert cfg.refine_cfg.step_xy == 0.03
    # absent -> disabled
    cfg2 = cfglib.engine_config_from({})
    assert cfg2.refine_matcher is None


def test_real_format_robotlaser_fixture():
    """Checked-in real-format CARMEN fixture (ROBOTLASER1 with remissions,
    PARAM lines, interleaved higher-rate ODOM records): both parsers must
    agree and extract geometry from the record header."""
    import os

    path = os.path.join(os.path.dirname(__file__), "data", "mini_robotlaser.clf")
    log_py = dataset._read_carmen_py(path)
    assert log_py.ranges.shape == (12, 181)
    assert abs(log_py.start_angle + np.pi / 2) < 1e-6
    assert abs(log_py.fov - np.pi) < 1e-6
    assert abs(log_py.max_range - 30.0) < 1e-6
    assert log_py.params["robot_frontlaser_offset"] == "0.08"
    assert log_py.true_poses is None
    # timestamps come from the laser records, not the ODOM interleave
    assert np.all(np.diff(log_py.timestamps) > 0.19)
    if dataset.native_lib() is not None:
        log_nat = dataset.read_carmen(path)
        np.testing.assert_allclose(log_nat.ranges, log_py.ranges, atol=1e-5)
        np.testing.assert_allclose(log_nat.odom_poses, log_py.odom_poses, atol=1e-9)
        np.testing.assert_allclose(log_nat.timestamps, log_py.timestamps, atol=1e-9)
        assert abs(log_nat.fov - log_py.fov) < 1e-9


def test_real_format_flaser_truepos_fixture():
    """FLASER fixture with PARAM-declared geometry and TRUEPOS ground truth:
    gt_at_scans resamples TRUEPOS at scan stamps; a short tiny-SLAM run on
    the parsed log lands near that ground truth (the one-command real-ATE
    path of bench_ate --dataset)."""
    import os

    import jax

    from slam_constructor_tpu.models import tiny
    from slam_constructor_tpu.ops.geometry import between
    from slam_constructor_tpu.utils import evaluate

    path = os.path.join(os.path.dirname(__file__), "data", "mini_flaser.clf")
    log = dataset.read_carmen(path)
    assert log.ranges.shape == (12, 181)
    # geometry came from PARAM lines (FLASER records carry none):
    # 181 beams at 1 deg -> fov = pi
    assert abs(log.fov - np.pi) < 1e-3
    assert abs(log.max_range - 30.0) < 1e-6
    gt = log.gt_at_scans()
    assert gt is not None and gt.shape == (12, 3)

    scans, odom, ts = dataset.to_sequence(log, max_range=29.0)
    e = tiny.make_engine(map_size=192, mc_batch=24, mc_rounds=8)
    e.state = e.state.replace(pose=jnp.asarray(gt[0]))
    traj, _ = e.run(scans, odom)
    ate = float(evaluate.ate(traj, jnp.asarray(gt), align=False))
    assert ate < 0.2, f"real-format log ATE {ate}"


def test_dataset_presets_build():
    """Per-dataset parameter presets (SURVEY §2.8 launch configs for MIT
    Stata / CSAIL / TUM) must build valid engine configs and carry their
    dataset-specific knobs through the dotted-key system."""
    import os

    from slam_constructor_tpu.utils import config as cfglib

    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    p = cfglib.load_properties(os.path.join(root, "mit_stata.properties"))
    cfg = cfglib.engine_config_from(p)
    assert cfg.map_storage == "tiled" and cfg.map_scale == 0.05
    assert cfg.beam.max_range == 10.0 and cfg.use_angle_histogram
    assert cfg.cell_model.__class__.__name__ == "TBMCell"

    p = cfglib.load_properties(os.path.join(root, "mit_csail.properties"))
    cfg = cfglib.engine_config_from(p)
    assert cfg.map_height == 1024 and cfg.refine_matcher == "hill_climbing"

    p = cfglib.load_properties(os.path.join(root, "tum_2d.properties"))
    assert "pf.particles" in p
    gcfg = cfglib.gmapping_config_from(p)
    assert gcfg.proposal == "improved" and gcfg.insert_window == 384
    assert gcfg.matcher_cfg.scoring.dtype == "bfloat16"
    assert gcfg.weight_gamma == 16.0


def test_viny_m3rsm_properties_mirror_preset():
    """configs/viny_m3rsm.properties must stay in lockstep with
    viny.viny_m3rsm_config(): the r2-r4 file silently carried the
    quality-broken pre-r5 knobs (obstacle reducer, no range cap, no
    free_impl pin) while the Python preset moved on."""
    from slam_constructor_tpu.models import viny
    from slam_constructor_tpu.utils import config as cfglib

    p = cfglib.load_properties("configs/viny_m3rsm.properties")
    c1 = cfglib.engine_config_from(p)
    c2 = viny.viny_m3rsm_config()
    m1, m2 = c1.matcher_cfg, c2.matcher_cfg
    for f in ("half_x", "half_y", "half_theta", "n_theta", "levels",
              "beam_width", "window", "refine_iterations"):
        assert getattr(m1, f) == getattr(m2, f), f
    assert m1.scoring.reducer == m2.scoring.reducer
    assert m1.scoring.stride == m2.scoring.stride
    for f in ("max_range", "occupancy_estimator", "hole_width",
              "wall_blur", "free_impl"):
        assert getattr(c1.beam, f) == getattr(c2.beam, f), f
    assert c1.use_angle_histogram == c2.use_angle_histogram
    assert type(c1.cell_model).__name__ == type(c2.cell_model).__name__
