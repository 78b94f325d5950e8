"""Headline benchmark: SLAM throughput (scans/sec) on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "scans/s", "vs_baseline": N/40,
   "device": {"platform": "gpu", "kind": ..., "count": N}}
Fails when JAX finds no GPU.

Baseline semantics: the reference (single-core C++ ROS node) publishes no
scans/sec figure but runs real-time against rosbag playback at sensor rate
(~40 Hz, BASELINE.md). vs_baseline therefore reports multiples of 40
scans/s.

Workload (tinySLAM preset, BASELINE config[0] shape): 360-beam scans, 256^2
map at 0.1 m/cell, Monte-Carlo matcher (64 candidates x 12 rounds => 768
score evaluations/scan) + full map insertion per scan, whole sequence
device-resident via lax.scan. Synthetic cecum-corridor data (datasets are
unreachable offline — SURVEY.md §6).

Env knobs: SLAM_BENCH_SCANS (default 512), SLAM_BENCH_BEAMS (360),
SLAM_BENCH_MAP (256), SLAM_BENCH_PRESET
(tiny|tiny_fast|viny|viny_m3rsm|gmapping|full),
SLAM_BENCH_DTYPE (float32|bfloat16 scoring-matmul operands),
SLAM_BENCH_STRIDE (matcher beam stride; the reference SPE's skip knob).
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def main():
    n_scans = int(os.environ.get("SLAM_BENCH_SCANS", 512))
    n_beams = int(os.environ.get("SLAM_BENCH_BEAMS", 360))
    map_size = int(os.environ.get("SLAM_BENCH_MAP", 256))
    preset = os.environ.get("SLAM_BENCH_PRESET", "tiny")

    from slam_constructor_tpu.utils import compile_cache, profiling

    compile_cache.enable()
    # a measurement with no GPU behind it is no measurement: fail, never
    # fall back to the CPU
    device = profiling.device_info()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {device})")

    from slam_constructor_tpu.models import engine as eng
    from slam_constructor_tpu.models import gmapping, tiny, viny
    from slam_constructor_tpu.ops import matchers, scoring
    from slam_constructor_tpu.utils import datagen

    sc = scoring.ScoringConfig(
        reducer="overlap",
        window=1,
        dtype=os.environ.get("SLAM_BENCH_DTYPE", "float32"),
        stride=int(os.environ.get("SLAM_BENCH_STRIDE", 1)),
    )
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=9.6 / n_scans * 2)
    # tile the loop to n_scans steps
    reps = (n_scans + poses.shape[0] - 1) // poses.shape[0]
    poses = jnp.tile(poses, (reps, 1))[:n_scans]
    bearings = datagen.default_bearings(n_beams)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, bearings, jax.random.PRNGKey(0),
        odom_noise_xy=0.01, odom_noise_theta=0.005,
    )

    if preset == "gmapping":
        # the fast operating point: f32 one-hot overlap scoring +
        # usable-range windows; see gmapping.fast_config
        cfg = gmapping.fast_config(n_particles=30, map_size=map_size)
        state = gmapping.init_state(cfg)
        run = lambda s: gmapping.run_sequence(cfg, s, scans, odom)
        metric = "gmapping_scans_per_sec"
    elif preset == "viny_m3rsm":
        # vinySLAM with the M3RSM global matcher every scan, windowed level
        # scoring
        cfg = viny.viny_m3rsm_config(map_size=map_size)
        state = eng.init_state(cfg)
        run = lambda s: eng.run_sequence(cfg, s, scans, odom)
        metric = "viny_m3rsm_scans_per_sec"
    elif preset == "full":
        # loop-closing pipeline, segmented device-resident tracking (one
        # host fetch per segment); throughput timed over the whole run so
        # keyframe/loop/optimize work is all included
        from slam_constructor_tpu.models import full, posegraph as pglib
        from slam_constructor_tpu.models import tiny as tinylib

        # Windowed fast tracker (tiny.fast_config, usable range 8 m +
        # stride 2) is the default: quality-neutral vs the full-map tracker
        # on the 5-seed 360-beam bench (2-lap ATE 0.0707/0.0720 mean/max vs
        # 0.0708/0.0716). SLAM_BENCH_FULL_FAST=0 runs the full-map tracker.
        if os.environ.get("SLAM_BENCH_FULL_FAST", "1") not in ("", "0"):
            # SLAM_BENCH_FULL_ROUNDS: tracker MC annealing rounds (the
            # tiny_fast eval-count lever brought to the pipeline)
            rounds = int(os.environ.get("SLAM_BENCH_FULL_ROUNDS", 12))
            tracking = tinylib.fast_config(
                map_size=map_size, stride=2, mc_rounds=rounds)
        else:
            tracking = tinylib.tiny_config(map_size=map_size)

        def make_full():
            e = full.FullSlamEngine(
                full.FullConfig(
                    tracking=tracking,
                    graph=pglib.PoseGraphConfig(
                        keyframe_distance=0.7, min_index_gap=8,
                        max_candidates=4, local_map_size=120,
                    ),
                    # BA stage batching: re-optimize once per 8 accumulated
                    # loop constraints (the PP low-rate stage; per-loop
                    # optimization would run GN ~70x over this sequence)
                    optimize_every_loops=8,
                ),
                n_beams=n_beams,
            )
            return e

        # segment=512 = ONE fused dispatch for the whole sequence: closure
        # bursts fire at keyframe-batch cadence inside it, so correction
        # latency does not depend on the segment length. Whole-sequence
        # 5-seed 2-lap ATE 0.0708 vs 0.0777 at segment 64 (every seed);
        # shorten segments only to bound host-visible correction latency
        seg = int(os.environ.get("SLAM_BENCH_SEGMENT", 512))
        # the shared bench trajectory covers <1 lap of the ~27 m rectangle
        # at these scan counts — no revisits, so loop closure would sit
        # idle. The full pipeline gets a 2-lap version of the same loop so
        # the keyframe graph actually closes (throughput then includes
        # detect+optimize work at its real rate).
        lap = datagen.rectangle_trajectory(step=2 * 27.2 / n_scans)
        reps2 = (n_scans + lap.shape[0] - 1) // lap.shape[0]
        poses2 = jnp.tile(lap, (reps2, 1))[:n_scans]
        scans, odom, gt = datagen.synth_sequence(
            occ, origin, scale, poses2, bearings, jax.random.PRNGKey(0),
            odom_noise_xy=0.01, odom_noise_theta=0.005,
        )
        e = make_full()
        e.run(scans, odom, segment=seg)  # warmup/compile
        e2 = make_full()
        t0 = time.perf_counter()
        e2.run(scans, odom, segment=seg)
        jax.block_until_ready(e2.state.pose)
        dt = time.perf_counter() - t0
        sps = n_scans / dt
        out = {
            "metric": "full_scans_per_sec",
            "value": round(sps, 2),
            "unit": "scans/s",
            "vs_baseline": round(sps / 40.0, 2),
            "device": device,
            "keyframes": int(e2.graph.n_kf),
            "loops": e2.total_loops,
        }
        print(json.dumps(out))
        return
    elif preset == "tiny_fast":
        # reduced-eval tiny operating point (5-seed-gated): at bench noise
        # 6 rounds x 64 match the 12-round preset (2-lap ATE 0.0721/0.0744
        # mean/max vs 0.0712/0.0719) for half the score evaluations. Under
        # 2x odometry noise it grows an outlier seed (max 0.1289) — use
        # mc_rounds=8 (0.0758/0.0794) for noisy-odometry deployments.
        cfg = tiny.tiny_config(
            map_size=map_size, mc_rounds=6, mc_batch=64, scoring_cfg=sc
        )
        state = eng.init_state(cfg)
        run = lambda s: eng.run_sequence(cfg, s, scans, odom)
        metric = "tiny_fast_scans_per_sec"
    else:
        mk = viny.viny_config if preset == "viny" else tiny.tiny_config
        # only override the preset's scoring when the caller asked for a
        # specific dtype/stride: viny ships stride-2 matching and the bench
        # must measure the SHIPPED preset, not a bench-local stride-1
        # variant
        explicit = (
            os.environ.get("SLAM_BENCH_DTYPE")
            or os.environ.get("SLAM_BENCH_STRIDE")
        )
        cfg = mk(map_size=map_size, scoring_cfg=sc if explicit else None)
        state = eng.init_state(cfg)
        run = lambda s: eng.run_sequence(cfg, s, scans, odom)
        metric = f"{preset}_scans_per_sec"

    # warmup/compile (run_sequence donates state; keep a pristine copy)
    state0 = jax.tree.map(lambda a: a.copy(), state)
    jax.block_until_ready(run(state))

    t0 = time.perf_counter()
    jax.block_until_ready(run(state0))
    dt = time.perf_counter() - t0

    sps = n_scans / dt
    if os.environ.get("SLAM_BENCH_KERNELS"):
        kernel_reports(scans, cfg)  # stderr; stdout stays one JSON line
    out = {
        "metric": metric,
        "value": round(sps, 2),
        "unit": "scans/s",
        "vs_baseline": round(sps / 40.0, 2),
        "device": device,
    }
    print(json.dumps(out))


def kernel_reports(scans, cfg) -> None:
    """Per-kernel speed-of-light roofline reports (BASELINE requirement),
    written to stderr as JSON lines."""
    import sys

    import jax

    from slam_constructor_tpu.models import engine as eng
    from slam_constructor_tpu.ops import matchers, raycast, scoring
    from slam_constructor_tpu.utils import profiling

    state = eng.init_state(cfg) if hasattr(cfg, "cell_model") else None
    if state is None:
        return
    model = cfg.cell_model
    s0 = jax.tree.map(lambda a: a[0], scans)
    gm = raycast.insert_scan(state.gm, model, jnp.zeros(3), s0, cfg.beam)
    view = scoring.MapView.of(gm, model)
    h, w = view.occ.shape
    r = s0.n_beams
    k = 64
    cand = jnp.zeros((k, 3))

    reports = []
    for impl in ("matmul", "gather"):
        sc = scoring.ScoringConfig(reducer="overlap", impl=impl)
        f = jax.jit(lambda v, s, c: scoring.score_poses(v, s, c, sc))
        t = profiling.timed(f, view, s0, cand, iters=10)
        n = k * r
        flops = 2.0 * n * h * w  # selection matmul dominates
        bytes_acc = 4.0 * (n * h + n * w + h * w + n * w)
        reports.append(profiling.sol_report(f"score_{impl}", t, flops, bytes_acc))

    f = jax.jit(
        lambda g, p, s: raycast.insert_scan(g, model, p, s, cfg.beam)
    )
    t = profiling.timed(f, gm, jnp.zeros(3), s0, iters=10)
    n_samples = r * cfg.beam.n_free_samples(gm.scale)
    reports.append(
        profiling.sol_report(
            "insert_scan", t, 2.0 * n_samples * (h + w),
            4.0 * (2 * h * w + n_samples * 4),
        )
    )

    mc = cfg.matcher_cfg if cfg.matcher == "monte_carlo" else matchers.MonteCarloConfig()
    f = jax.jit(lambda v, s, p, key: matchers.monte_carlo_match(v, s, p, key, mc))
    t = profiling.timed(f, view, s0, jnp.zeros(3), jax.random.PRNGKey(0), iters=5)
    reports.append({"kernel": "mc_match_full", "measured_ms": t * 1e3})

    for rep in reports:
        print(json.dumps(rep), file=sys.stderr)


if __name__ == "__main__":
    main()
