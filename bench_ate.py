"""Quality benchmark: ATE across all presets on the standard synthetic
sequence (offline stand-in for MIT Stata/CSAIL until datasets are reachable
— SURVEY.md §6). Prints one JSON line per preset.

Sequence: two laps around the cecum world's inner block (loop closures
available), 120 beams, odometry noise 2 cm / 0.012 rad per step.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def dataset_main(path: str, preset: str, out: str | None) -> None:
    """Real-dataset mode: ``python bench_ate.py --dataset <carmen.clf>``.

    Parses a CARMEN log (FLASER/ROBOTLASER1; native parser when available),
    runs the chosen preset, and prints one JSON line. ATE is reported when
    the log carries TRUEPOS ground truth; the estimated trajectory is
    written in TUM format (--out) so external ATE tooling can score runs
    whose ground truth ships separately (MIT Stata/TUM style)."""
    import jax

    if os.environ.get("SLAM_ATE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from slam_constructor_tpu.models import gmapping, tiny, viny
    from slam_constructor_tpu.utils import compile_cache, dataset, evaluate, trajectory

    compile_cache.enable()

    log = dataset.read_carmen(path)
    scans, odom, ts = dataset.to_sequence(log)
    gt = log.gt_at_scans()
    n = int(odom.shape[0])

    t0 = time.perf_counter()
    if preset == "gmapping":
        e = gmapping.GMappingEngine(
            gmapping.GMappingConfig(n_particles=16, map_height=512,
                                    map_width=512)
        )
        if gt is not None:
            e.state = e.state.replace(
                poses=jnp.broadcast_to(jnp.asarray(gt[0]), (16, 3))
            )
        e.run(scans, odom)
        # the RBPF's output trajectory is the genealogy-consistent winner
        # path (same methodology as the synthetic bench), not the per-step
        # argmax, which hops between hypothesis frames
        traj = e.winner_trajectory()
    else:
        mk = viny.make_engine if preset == "viny" else tiny.make_engine
        e = mk(map_size=512)
        if gt is not None:
            e.state = e.state.replace(pose=jnp.asarray(gt[0]))
        traj, _ = e.run(scans, odom)
    jax.block_until_ready(traj)
    dt = time.perf_counter() - t0

    rec = {"preset": preset, "dataset": os.path.basename(path), "scans": n,
           "scans_per_sec": round(n / dt, 2)}
    if gt is not None:
        rec["ate_m"] = round(float(evaluate.ate(traj, jnp.asarray(gt),
                                                align=False)), 4)
        rpe_t, rpe_r = evaluate.rpe(traj, jnp.asarray(gt))
        rec["rpe_t_m"] = round(float(rpe_t), 4)
    if out:
        trajectory.save_tum(out, np.asarray(traj), np.asarray(ts))
        rec["trajectory"] = out
    print(json.dumps(rec), flush=True)


def main():
    import jax

    if os.environ.get("SLAM_ATE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from slam_constructor_tpu.models import full, gmapping, posegraph as pg, tiny, viny
    from slam_constructor_tpu.utils import compile_cache, datagen, evaluate

    compile_cache.enable()

    n_beams = int(os.environ.get("SLAM_ATE_BEAMS", 120))
    laps = int(os.environ.get("SLAM_ATE_LAPS", 2))

    occ, origin, scale = datagen.cecum_world()
    lap = datagen.rectangle_trajectory(step=0.3)
    poses = jnp.tile(lap, (laps, 1))
    bearings = datagen.default_bearings(n_beams)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(42),
        odom_noise_xy=0.02, odom_noise_theta=0.012,
    )
    n = int(odom.shape[0])

    def report(name, traj, t0, dt=None):
        dt = time.perf_counter() - t0 if dt is None else dt
        ate = float(evaluate.ate(traj, gt[: traj.shape[0]], align=False))
        rpe_t, rpe_r = evaluate.rpe(traj, gt[: traj.shape[0]])
        print(json.dumps({
            "preset": name, "scans": n, "ate_m": round(ate, 4),
            "rpe_t_m": round(float(rpe_t), 4),
            "rpe_r_rad": round(float(rpe_r), 4),
            "scans_per_sec": round(n / dt, 2),
        }), flush=True)

    # odometry-only baseline (what the matcher must beat)
    from slam_constructor_tpu.ops.geometry import compose
    p = gt[0]
    odo = [p]
    for d in odom[1:]:
        p = compose(p, d)
        odo.append(p)
    report("odometry_only", jnp.stack(odo), time.perf_counter())

    from slam_constructor_tpu.models.engine import Engine as _Engine

    for name, make in [
        ("tiny", lambda: tiny.make_engine(mc_batch=48, mc_rounds=12)),
        ("viny", lambda: viny.make_engine(mc_batch=48, mc_rounds=12)),
        # every preset with a throughput row gets a quality leg here (see
        # viny.viny_m3rsm_config for the constraints that fix its point)
        ("viny_m3rsm", lambda: _Engine(viny.viny_m3rsm_config())),
    ]:
        e = make()
        e.state = e.state.replace(pose=gt[0])
        t0 = time.perf_counter()
        traj, _ = e.run(scans, odom)
        jax.block_until_ready(traj)
        report(name, traj, t0)

    from slam_constructor_tpu.ops import matchers as mlib

    gcfg = gmapping.GMappingConfig(
        n_particles=16, map_height=256, map_width=256,
        matcher_cfg=mlib.MonteCarloConfig(
            sigma_xy=0.08, sigma_theta=0.04, batch=24, rounds=8
        ),
    )
    e = gmapping.GMappingEngine(gcfg)
    e.state = e.state.replace(poses=jnp.broadcast_to(gt[0], (16, 3)))
    t0 = time.perf_counter()
    traj, _ = e.run(scans, odom)
    jax.block_until_ready(traj)
    dt_run = time.perf_counter() - t0  # frozen: throughput = the RBPF run
    # online = per-step best particle; the RBPF's canonical output is the
    # final winner's genealogy-consistent trajectory (how the reference's
    # published ATE is scored: offline, on the output trajectory)
    report("gmapping_online", traj, t0, dt=dt_run)
    win = e.winner_trajectory()
    report("gmapping", win, t0, dt=dt_run)

    # the fast operating point (one-hot windows, 6 m usable range) on the
    # same harness — the apples-to-apples quality check for the speed preset
    e = gmapping.GMappingEngine(gmapping.fast_config(n_particles=30))
    e.state = e.state.replace(poses=jnp.broadcast_to(gt[0], (30, 3)))
    t0 = time.perf_counter()
    traj, _ = e.run(scans, odom)
    jax.block_until_ready(traj)
    dt_run = time.perf_counter() - t0
    report("gmapping_fast_online", traj, t0, dt=dt_run)
    report("gmapping_fast", e.winner_trajectory(), t0, dt=dt_run)

    graph = pg.PoseGraphConfig(
        max_keyframes=128, max_edges=512, keyframe_distance=0.7,
        loop_radius=2.0, min_index_gap=8, min_prob=0.65, max_candidates=4,
        local_map_size=120, gn_iterations=12,
    )
    e = full.FullSlamEngine(
        full.FullConfig(tracking=tiny.tiny_config(mc_batch=48, mc_rounds=12),
                        graph=graph),
        n_beams=n_beams,
    )
    e.state = e.state.replace(pose=gt[0])
    t0 = time.perf_counter()
    traj = e.run(scans, odom)
    jax.block_until_ready(traj)
    report("full_posegraph", traj, t0)
    print(json.dumps({"preset": "full_posegraph_info",
                      "keyframes": int(e.graph.n_kf),
                      "loops": e.total_loops}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", help="CARMEN log file (real-dataset mode)")
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "viny", "gmapping"])
    ap.add_argument("--out", help="write estimated trajectory (TUM format)")
    args = ap.parse_args()
    if args.dataset:
        dataset_main(args.dataset, args.preset, args.out)
    else:
        main()
