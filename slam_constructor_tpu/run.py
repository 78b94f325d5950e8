"""CLI runner: the reference's node ``main()`` equivalent.

Where the reference wires a ROS node per algorithm (tiny_slam / viny_slam /
gmapping nodes, launch files choosing parameters — SURVEY.md §3.1), this is
one offline driver:

    python -m slam_constructor_tpu.run --preset tiny --dataset log.clf \
        --out out/
    python -m slam_constructor_tpu.run --config configs/viny.properties \
        --synthetic cecum --steps 200 --out out/

Outputs: TUM trajectory, PGM+YAML map, RGB render, per-step metrics JSONL,
and a JSON summary (ATE when ground truth is known) on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_engine(args, n_beams: int):
    from .models import full, gmapping, tiny, viny
    from .utils import config as cfglib

    if args.config:
        props = cfglib.load_properties(args.config)
        if "pf.particles" in props:
            cfg = cfglib.gmapping_config_from(props)
            return gmapping.GMappingEngine(cfg), "gmapping"
        from .models.engine import Engine

        return Engine(cfglib.engine_config_from(props)), "engine"
    preset = args.preset
    if preset in ("tiny", "viny"):
        mk = tiny.tiny_config if preset == "tiny" else viny.viny_config
        cfg = mk(map_size=args.map_size)
        if args.map_storage == "tiled":
            import dataclasses

            cfg = dataclasses.replace(
                cfg, map_storage="tiled",
                tile_capacity=(args.map_size // 32) ** 2,
            )
        from .models.engine import Engine

        return Engine(cfg), "engine"
    if preset == "gmapping":
        return (
            gmapping.GMappingEngine(
                n_particles=args.particles,
                map_height=args.map_size,
                map_width=args.map_size,
            ),
            "gmapping",
        )
    if preset == "full":
        return full.FullSlamEngine(n_beams=n_beams), "full"
    raise SystemExit(f"unknown preset {preset!r}")


def load_data(args, key):
    import jax

    from .utils import datagen, dataset

    if args.dataset:
        log = dataset.read_carmen(args.dataset)
        scans, odom, ts = dataset.to_sequence(
            log, beam_stride=args.beam_stride, scan_stride=args.scan_stride
        )
        gt = log.gt_at_scans()  # TRUEPOS ground truth when the log has it
        if gt is not None:
            gt = jax.numpy.asarray(gt[:: args.scan_stride])
        return scans, odom, gt
    # synthetic
    occ, origin, scale = (
        datagen.cecum_world() if args.synthetic == "cecum" else datagen.box_world()
    )
    if args.trajectory == "rectangle":
        poses = datagen.rectangle_trajectory(step=0.25)
    else:
        poses = datagen.corridor_trajectory(args.steps)
    reps = (args.steps + poses.shape[0] - 1) // poses.shape[0]
    import jax.numpy as jnp

    poses = jnp.tile(poses, (reps, 1))[: args.steps]
    bearings = datagen.default_bearings(args.beams)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, key,
        odom_noise_xy=args.odom_noise, odom_noise_theta=args.odom_noise / 2,
    )
    return scans, odom, gt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "viny", "gmapping", "full"])
    ap.add_argument("--config", help=".properties file (overrides --preset)")
    ap.add_argument("--dataset", help="CARMEN log file (MIT Stata/CSAIL format)")
    ap.add_argument("--synthetic", default="cecum", choices=["cecum", "box"])
    ap.add_argument("--trajectory", default="corridor",
                    choices=["corridor", "rectangle"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--odom-noise", type=float, default=0.01)
    ap.add_argument("--map-size", type=int, default=256)
    ap.add_argument("--map-storage", default="dense", choices=["dense", "tiled"])
    ap.add_argument("--particles", type=int, default=30)
    ap.add_argument("--beam-stride", type=int, default=1)
    ap.add_argument("--scan-stride", type=int, default=1)
    ap.add_argument("--out", default="slam_out")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from .utils import compile_cache, evaluate
    from .utils import metrics as metricslib, trajectory as tio, viz

    compile_cache.enable()

    key = jax.random.PRNGKey(0)
    scans, odom, gt = load_data(args, key)
    n_scans, n_beams = scans.ranges.shape
    engine, kind = build_engine(args, n_beams)
    if gt is not None:
        # anchor the map frame at the true start pose
        if kind == "gmapping":
            p = engine.state.poses.shape[0]
            engine.state = engine.state.replace(
                poses=jnp.broadcast_to(gt[0], (p, 3))
            )
        else:
            engine.state = engine.state.replace(pose=gt[0])

    mlog = metricslib.MetricsLogger()
    t0 = time.perf_counter()
    if kind == "full":
        traj = engine.run(scans, odom)
    else:
        traj, aux = engine.run(scans, odom)
    jax.block_until_ready(traj)
    dt = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    tio.save_tum(os.path.join(args.out, "trajectory.tum"), np.asarray(traj))
    occ = np.asarray(engine.occupancy)
    tio.save_map_pgm(os.path.join(args.out, "map.pgm"), occ)
    gm = engine.state.gm
    origin = np.asarray(gm.origin if gm.origin.ndim == 1 else gm.origin[0])
    scale = gm.scale
    viz.save_map_yaml(os.path.join(args.out, "map.yaml"), "map.pgm", origin, scale)
    rgb = viz.render_map_rgb(occ, np.asarray(traj), origin, scale,
                             gt=None if gt is None else np.asarray(gt))
    viz.save_png(os.path.join(args.out, "map.png"), rgb)
    mlog.log(n_scans, wall_s=dt, scans_per_sec=n_scans / dt)
    mlog.save_jsonl(os.path.join(args.out, "metrics.jsonl"))

    summary = {
        "preset": args.config or args.preset,
        "scans": int(n_scans),
        "beams": int(n_beams),
        "wall_s": round(dt, 3),
        "scans_per_sec": round(n_scans / dt, 2),
        "out": args.out,
    }
    if gt is not None:
        summary["ate_m"] = round(float(evaluate.ate(traj, gt, align=False)), 4)
        t_err, r_err = evaluate.rpe(traj, gt)
        summary["rpe_t_m"] = round(float(t_err), 4)
        summary["rpe_r_rad"] = round(float(r_err), 4)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
