"""Smoke test of the SLAM engine on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
shipped shapes (360-beam scans, a 256^2 map at 0.1 m, the synthetic cecum
world), compares each operation of that path with its plain reference at
those widths, and checks the results:

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded dry run only

Phases: device, reference, end-to-end, determinism, memory. Every phase
raises on failure, so the process exits non-zero and prints no result line.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import tempfile
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from slam_constructor_tpu.models import engine as eng
from slam_constructor_tpu.models import full, gmapping, posegraph as pg, tiny, viny
from slam_constructor_tpu.ops import grid, raycast, scoring
from slam_constructor_tpu.ops.geometry import compose, wrap_angle
from slam_constructor_tpu.utils import compile_cache, datagen, evaluate, profiling


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one smoke run. The defaults are the shipped shapes; the
    CPU tests pass toy ones."""

    n_beams: int = 360
    map_size: int = 256
    #: (scans, laps of the ~27.2 m cecum loop) of each sequence: the
    #: bench's 512 scans over 0.7 lap for the single-hypothesis trackers,
    #: 2 laps so the loop-closing pipeline closes its graph, and 2 laps in
    #: ~0.3 m steps for the RBPF, whose proposal noise (0.03 m, 0.015 rad
    #: per step) is sized for GMapping-style update distances
    track: tuple = (512, 0.7)
    loop: tuple = (512, 2.0)
    rbpf: tuple = (184, 2.0)
    #: candidate poses per score call (tiny: 64 candidates x 12 rounds)
    n_poses: int = 768
    #: particles of the gmapping preset
    n_particles: int = 30
    #: keyframes of the Gauss-Newton reference graph
    n_keyframes: int = 128
    #: scans of the in-process ``run.main`` call
    run_steps: int = 200
    odom_noise_xy: float = 0.01
    odom_noise_theta: float = 0.005


def report(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# --- device -------------------------------------------------------------------


def device_phase(n_devices: int = 1) -> dict:
    """Fail unless JAX runs on at least ``n_devices`` GPUs; print what it
    found and the card's name and power limit."""
    info = profiling.device_info()
    check(info["platform"] == "gpu", f"no GPU: JAX found {info}")
    check(info["count"] >= n_devices, f"need {n_devices} GPUs, found {info}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    report("device", kind=repr(info["kind"]), count=info["count"])
    print(smi, flush=True)
    return info


# --- shared inputs ------------------------------------------------------------


def bench_sequence(sizes: Sizes, kind: str = "track"):
    """A synthetic sequence: ``sizes.<kind>`` = (scans, laps) spread over
    the cecum world's ~27.2 m inner loop, scans cast against the world,
    noisy odometry. Returns ``(scans, odom, gt)``."""
    occ, origin, scale = datagen.cecum_world()
    n, laps = getattr(sizes, kind)
    lap = datagen.rectangle_trajectory(step=27.2 * laps / n)
    poses = jnp.tile(lap, (-(-n // lap.shape[0]), 1))[:n]
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(sizes.n_beams),
        jax.random.PRNGKey(0), odom_noise_xy=sizes.odom_noise_xy,
        odom_noise_theta=sizes.odom_noise_theta,
    )


def odometry_only(gt0, odom):
    """Dead-reckoned trajectory: ``gt[0]`` composed with every odometry
    delta after the first (the trajectory the matcher must beat)."""

    def body(p, d):
        p = compose(p, d)
        return p, p

    _, rest = jax.lax.scan(body, gt0, odom[1:])
    return jnp.concatenate([gt0[None], rest])


def _mapped_view(sizes: Sizes, scans, gt, n_insert: int = 8):
    """A ``tiny`` map built from the first scans at their true poses."""
    cfg = tiny.tiny_config(map_size=sizes.map_size)
    gm = grid.make_grid_map(cfg.cell_model, sizes.map_size, sizes.map_size, 0.1)
    for t in range(n_insert):
        s = jax.tree.map(lambda a: a[t], scans)
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[t], s, cfg.beam)
    return cfg, gm


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# --- references ---------------------------------------------------------------


def reference_phase(sizes: Sizes) -> None:
    """Compare every operation of the main path on the default device with
    its plain reference: the same function on the CPU device, float64
    NumPy, or an exact alternative form on the same device."""
    cpu = jax.devices("cpu")[0]
    scans, odom, gt = bench_sequence(sizes)
    cfg, gm = _mapped_view(sizes, scans, gt)
    model = cfg.cell_model
    view = scoring.MapView.of(gm, model)
    t = 8
    scan = jax.tree.map(lambda a: a[t], scans)
    poses = gt[t] + jax.random.normal(
        jax.random.PRNGKey(1), (sizes.n_poses, 3)
    ) * jnp.array([0.1, 0.1, 0.05])

    # 1. gather scorer (what impl='auto' runs) against the same function
    # on the CPU: no matmul, so differences come from operation order only
    sc = {
        impl: scoring.ScoringConfig(reducer="overlap", window=1, impl=impl)
        for impl in ("gather", "matmul")
    }
    score = {
        impl: jax.jit(partial(scoring.score_poses, cfg=c)) for impl, c in sc.items()
    }
    got = score["gather"](view, scan, poses)
    want = score["gather"](*jax.device_put((view, scan, poses), cpu))
    d, tol = _max_diff(got, want), 1e-5
    report("reference", op="score_poses[gather,overlap]", vs="cpu",
           shape=f"{sizes.n_poses}x{sizes.n_beams}@{sizes.map_size}^2",
           max_abs_diff=d, tol=tol)
    check(d <= tol, "gather scorer differs from the CPU")

    # 2. matmul sampler at HIGHEST precision against gather on this device:
    # shows the precision pin holds (TF32 would miss by ~1e-3)
    got_m = score["matmul"](view, scan, poses)
    d, tol = _max_diff(got_m, got), 2e-6
    report("reference", op="score_poses[matmul,overlap]", vs="gather",
           max_abs_diff=d, tol=tol)
    check(d <= tol, "matmul scorer differs from gather")
    t_g = profiling.timed(score["gather"], view, scan, poses)
    t_m = profiling.timed(score["matmul"], view, scan, poses)
    report("timing", op="score_poses[overlap]",
           shape=f"{sizes.n_poses}x{sizes.n_beams}@{sizes.map_size}^2",
           gather_ms=t_g * 1e3, matmul_ms=t_m * 1e3)

    # 3. insert: DDA samples, then the two accumulations insert_scan uses.
    # The unit counts (free-space crossings, endpoint hits; XLA scatter-add)
    # must accumulate exactly; the fractional wall-blur ramp weights (sorted
    # segment sum) within float32 summation error of float64, and bitwise
    # the same on a second call.
    pose = gt[t]
    rows, cols, w, s = jax.jit(
        lambda o, p, sc_: raycast.scan_sample_cells(o, gm.scale, p, sc_, cfg.beam)
    )(gm.origin, pose, scan)
    h = wdt = sizes.map_size
    r_np, c_np, w_np = (np.asarray(a) for a in (rows, cols, w))
    unit = (w_np == 0) | (w_np == 1)
    check(not unit.all(), "no fractional weights to test")
    counts = jax.jit(partial(raycast._flat_scatter_add, (h, wdt), impl="scatter"))
    weights = jax.jit(
        lambda r, c, v, ok: raycast._sorted_segment_add((h, wdt), r, c, v[:, None], ok)[..., 0]
    )
    for name, sel, tol, acc in (("counts", unit, 0.0, counts),
                                ("all_weights", None, 1e-5, weights)):
        keep = np.ones_like(unit) if sel is None else sel
        valid = keep & (w_np > 0)
        got_p = acc(rows, cols, w, jnp.asarray(valid))
        again = acc(rows, cols, w, jnp.asarray(valid))
        check(np.array_equal(np.asarray(got_p), np.asarray(again)),
              f"{name}: two accumulations differ")
        ok = valid & (r_np >= 0) & (r_np < h) & (c_np >= 0) & (c_np < wdt)
        want_p = np.zeros((h, wdt), np.float64)
        np.add.at(want_p, (r_np[ok], c_np[ok]), w_np[ok].astype(np.float64))
        d = _max_diff(got_p, want_p)
        report("reference", op=f"insert_scatter[{name}]", vs="numpy_f64",
               samples=int(ok.sum()), max_abs_diff=d, tol=tol)
        check(d <= tol, f"scatter-add {name} differ from float64")

    # the whole insert against the CPU: sample cells come from sin/cos and
    # floor, whose last-ulp differences between backends can move a sample
    # to a neighboring cell — count such cells and bound them
    ins = jax.jit(lambda g, p, sc_: raycast.insert_scan(g, model, p, sc_, cfg.beam))
    got_g = np.asarray(ins(gm, pose, scan).cells)
    want_g = np.asarray(ins(*jax.device_put((gm, pose, scan), cpu)).cells)
    moved = int((np.abs(got_g - want_g) > 1e-5).any(-1).sum())
    touched = int((np.asarray(gm.cells) != got_g).any(-1).sum())
    report("reference", op="insert_scan[dda,scatter]", vs="cpu",
           cells_touched=touched, cells_differing=moved, tol_cells=touched // 1000)
    check(moved <= touched // 1000, "insert differs from the CPU")

    # 4. polar free fill: the one-hot range lookup at HIGHEST precision
    # returns every range exactly, so the plane is bitwise the one built
    # with a take (plane and geometry come from one program, so both read
    # the same per-cell distances and weights)
    pcfg = dataclasses.replace(cfg.beam, free_impl="polar")

    @jax.jit
    def polar(p, sc_):
        args = (h, wdt, gm.origin, gm.scale, p, sc_)
        return raycast._polar_free_plane(*args, pcfg), raycast._polar_cells(*args)

    plane, (d_, bini, ok_, wgt, rng) = jax.tree.map(np.asarray, polar(pose, scan))
    cell_range = np.take(rng, bini)
    lookup = np.asarray(jax.jit(raycast._polar_range_lookup)(bini, rng))
    want_plane = np.where(
        ok_ & (d_ < cell_range - pcfg.hole_width / 2.0) & (d_ < pcfg.max_range), wgt, 0.0
    )
    report("reference", op="polar_free_plane", vs="numpy_take",
           lookup_bitwise=bool(np.array_equal(lookup, cell_range)),
           plane_bitwise=bool(np.array_equal(plane, want_plane)))
    check(np.array_equal(lookup, cell_range), "polar range lookup is not exact")
    check(np.array_equal(plane, want_plane), "polar plane differs from the take form")

    # 5. gmapping window extraction + write-back: one-hot matmuls against
    # dynamic slices, bitwise, through the whole RBPF step
    gcfg_o = gmapping.fast_config(n_particles=sizes.n_particles, map_size=sizes.map_size)
    gcfg_s = dataclasses.replace(gcfg_o, match_window_impl="slice", insert_impl="slice")
    outs = []
    for gcfg in (gcfg_o, gcfg_s):
        st = gmapping.init_state(gcfg)
        st = st.replace(poses=jnp.broadcast_to(gt[0], st.poses.shape))
        step = jax.jit(partial(gmapping.gmapping_step, gcfg))
        for k in range(3):
            st, _ = step(st, jax.tree.map(lambda a: a[k], scans), odom[k])
        outs.append(st)
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in ((outs[0].poses, outs[1].poses), (outs[0].gm.cells, outs[1].gm.cells),
                     (outs[0].log_weights, outs[1].log_weights))
    )
    win_o = scoring.window_view_onehot(view, pose[:2], gcfg_o.match_window)
    win_s = scoring.window_view(view, pose[:2], gcfg_o.match_window)
    win_same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(win_o), jax.tree.leaves(win_s))
    )
    report("reference", op="gmapping_window[onehot]", vs="slice",
           window_bitwise=win_same, rbpf_3_steps_bitwise=same)
    check(win_same and same, "one-hot window path differs from slices")

    # 6. Gauss-Newton on a K-keyframe graph against float64 NumPy
    gcfg, gst = _reference_graph(sizes)
    got_p = np.asarray(jax.jit(partial(pg.optimize, gcfg))(gst).kf_poses)
    want_p = _gauss_newton_f64(gcfg, gst)
    n = int(gst.n_kf)
    d_xy = _max_diff(got_p[:n, :2], want_p[:n, :2])
    d_th = float(np.max(np.abs(np.asarray(wrap_angle(jnp.asarray(got_p[:n, 2] - want_p[:n, 2]))))))
    report("reference", op="posegraph.optimize", vs="numpy_f64_gauss_newton",
           keyframes=n, edges=int(gst.n_edges), max_xy_diff_m=d_xy,
           max_theta_diff_rad=d_th, tol="1e-4 m, 1e-4 rad")
    check(d_xy <= 1e-4 and d_th <= 1e-4, "Gauss-Newton differs from float64")


def _reference_graph(sizes: Sizes):
    """K keyframes around a circle: noisy odometry chain edges plus loop
    edges between keyframes half a lap apart and across the closure."""
    k = sizes.n_keyframes
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
    true = np.stack([8 * np.cos(ang), 8 * np.sin(ang), ang + np.pi / 2], -1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        dx, dy = b[:2] - a[:2]
        return np.array([c * dx + s * dy, -s * dx + c * dy,
                         np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))])

    edges = [(i, i + 1, False) for i in range(k - 1)]
    edges += [(i, i + k // 2, True) for i in range(0, k // 2, 4)]
    edges += [(k - 1 - i, i, True) for i in range(3)]
    cfg = pg.PoseGraphConfig(max_keyframes=k, max_edges=-(-len(edges) // 8) * 8)
    e = cfg.max_edges
    ei, ej, dz, info, loop = (np.zeros(e, np.int32), np.zeros(e, np.int32),
                              np.zeros((e, 3), np.float32), np.zeros((e, 3), np.float32),
                              np.zeros(e, bool))
    for n, (i, j, is_loop) in enumerate(edges):
        ei[n], ej[n], loop[n] = i, j, is_loop
        noise = rng.normal(0, [0.02, 0.02, 0.005]) if not is_loop else 0.0
        dz[n] = rel(true[i], true[j]) + noise
        info[n] = (50.0, 50.0, 200.0) if is_loop else (100.0, 100.0, 400.0)
    # initial estimate: dead reckoning along the chain edges
    est = [true[0]]
    for n in range(k - 1):
        p, d = est[-1], dz[n]
        c, s = np.cos(p[2]), np.sin(p[2])
        est.append(np.array([p[0] + c * d[0] - s * d[1], p[1] + s * d[0] + c * d[1], p[2] + d[2]]))
    st = pg.init_state(cfg, 8).replace(
        kf_poses=jnp.asarray(np.stack(est), jnp.float32),
        n_kf=jnp.int32(k), last_kf=jnp.int32(k - 1),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        edge_delta=jnp.asarray(dz), edge_info=jnp.asarray(info),
        edge_is_loop=jnp.asarray(loop), n_edges=jnp.int32(len(edges)),
    )
    return cfg, st


def _gauss_newton_f64(cfg: pg.PoseGraphConfig, st) -> np.ndarray:
    """``posegraph.optimize`` written out in float64 NumPy: dense normal
    equations, Huber weights on loop edges, gauge anchor at keyframe 0."""
    k = cfg.max_keyframes
    poses = np.asarray(st.kf_poses, np.float64)
    n_kf, n_e = int(st.n_kf), int(st.n_edges)
    ei, ej = np.asarray(st.edge_i)[:n_e], np.asarray(st.edge_j)[:n_e]
    z = np.asarray(st.edge_delta, np.float64)[:n_e]
    info = np.asarray(st.edge_info, np.float64)[:n_e]
    loop = np.asarray(st.edge_is_loop)[:n_e]
    wrap = lambda a: np.arctan2(np.sin(a), np.cos(a))
    used = np.repeat((np.arange(k) < n_kf) & (np.arange(k) > 0), 3)
    for _ in range(cfg.gn_iterations):
        h = np.zeros((3 * k, 3 * k))
        b = np.zeros(3 * k)
        for n in range(n_e):
            pi, pj = poses[ei[n]], poses[ej[n]]
            c, s = np.cos(pi[2]), np.sin(pi[2])
            rt = np.array([[c, s], [-s, c]])
            dt = pj[:2] - pi[:2]
            e = np.concatenate([rt @ dt - z[n, :2], [wrap(pj[2] - pi[2] - z[n, 2])]])
            drt = np.array([[-s, c], [-c, -s]])
            ji = np.zeros((3, 3))
            ji[:2, :2], ji[:2, 2], ji[2, 2] = -rt, drt @ dt, -1.0
            jj = np.zeros((3, 3))
            jj[:2, :2], jj[2, 2] = rt, 1.0
            w = info[n].copy()
            if cfg.huber_delta > 0 and loop[n]:
                w *= min(1.0, cfg.huber_delta / np.sqrt(max((w * e * e).sum(), 1e-12)))
            si, sj = slice(3 * ei[n], 3 * ei[n] + 3), slice(3 * ej[n], 3 * ej[n] + 3)
            h[si, si] += ji.T * w @ ji
            h[si, sj] += ji.T * w @ jj
            h[sj, si] += jj.T * w @ ji
            h[sj, sj] += jj.T * w @ jj
            b[si] += ji.T @ (w * e)
            b[sj] += jj.T @ (w * e)
        h = np.where(used[:, None] & used[None, :], h, 0.0)
        h += np.diag(np.where(used, cfg.gn_damping, 1.0))
        b = np.where(used, b, 0.0)
        poses = poses + np.linalg.solve(h, -b).reshape(k, 3)
        poses[:, 2] = wrap(poses[:, 2])
    return poses


# --- end to end ---------------------------------------------------------------


def _engine_runner(cfg, gt0):
    def run(scans, odom):
        # run_sequence donates its state: give every run fresh buffers
        st = eng.init_state(cfg).replace(pose=jnp.array(gt0))
        st, traj, _ = eng.run_sequence(cfg, st, scans, odom)
        return traj, st.gm.cells

    return run


def _gmapping_runner(cfg, gt0):
    def run(scans, odom):
        st = gmapping.init_state(cfg)
        st = st.replace(poses=jnp.broadcast_to(gt0, st.poses.shape))
        st, _, _, all_poses, anc = gmapping.run_sequence(cfg, st, scans, odom)
        traj = gmapping.winner_trajectory(all_poses, anc, gmapping.best_particle(st))
        return traj, st.gm.cells

    return run


def _full_runner(sizes: Sizes, gt0):
    def run(scans, odom):
        e = full.FullSlamEngine(
            full.FullConfig(
                tracking=tiny.fast_config(map_size=sizes.map_size, stride=2),
                graph=pg.PoseGraphConfig(
                    keyframe_distance=0.7, min_index_gap=8, max_candidates=4,
                    local_map_size=120,
                ),
                optimize_every_loops=8,
            ),
            n_beams=sizes.n_beams,
        )
        e.state = e.state.replace(pose=jnp.array(gt0))
        traj = e.run(scans, odom, segment=sizes.loop[0])
        return traj, e.state.gm.cells

    return run


PRESETS = ("tiny", "tiny_fast", "viny", "viny_m3rsm", "gmapping", "full")


def _runner(name: str, sizes: Sizes, gt0):
    m = sizes.map_size
    if name == "tiny":
        return _engine_runner(tiny.tiny_config(map_size=m), gt0)
    if name == "tiny_fast":
        return _engine_runner(tiny.tiny_config(map_size=m, mc_rounds=6), gt0)
    if name == "viny":
        return _engine_runner(viny.viny_config(map_size=m), gt0)
    if name == "viny_m3rsm":
        return _engine_runner(viny.viny_m3rsm_config(map_size=m), gt0)
    if name == "gmapping":
        return _gmapping_runner(
            gmapping.fast_config(n_particles=sizes.n_particles, map_size=m), gt0
        )
    if name == "full":
        return _full_runner(sizes, gt0)
    raise ValueError(name)


def end_to_end_phase(sizes: Sizes, presets=PRESETS) -> dict:
    """Run each preset over a whole sequence through its normal entry
    point, twice: a compile run, then a timed one that ends in
    ``block_until_ready``. ATE must be finite and below dead reckoning.
    Returns ``{preset: (traj, map cells)}`` of the timed runs."""
    out = {}
    for name in presets:
        kind = {"full": "loop", "gmapping": "rbpf"}.get(name, "track")
        scans, odom, gt = bench_sequence(sizes, kind)
        n = scans.ranges.shape[0]
        run = _runner(name, sizes, gt[0])
        t0 = time.perf_counter()
        jax.block_until_ready(run(scans, odom))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(scans, odom))
        dt = time.perf_counter() - t0
        ate = float(evaluate.ate(res[0], gt, align=False))
        ate_odo = float(evaluate.ate(odometry_only(gt[0], odom), gt, align=False))
        report("e2e", preset=name, scans=n, laps=getattr(sizes, kind)[1],
               beams=sizes.n_beams, map=f"{sizes.map_size}^2", first_run_s=t_first,
               steady_s=dt, scans_per_s=n / dt, ate_m=ate, odometry_only_ate_m=ate_odo)
        check(math.isfinite(ate) and ate < ate_odo, f"{name}: ATE {ate} vs odometry {ate_odo}")
        out[name] = res
    return out


def run_main_phase(sizes: Sizes) -> dict:
    """``slam_constructor_tpu.run.main`` once, in process."""
    from slam_constructor_tpu import run

    with tempfile.TemporaryDirectory() as out:
        summary = run.main([
            "--preset", "tiny", "--steps", str(sizes.run_steps),
            "--beams", str(sizes.n_beams), "--map-size", str(sizes.map_size),
            "--out", out,
        ])
    check(math.isfinite(summary["ate_m"]), f"run.main ATE {summary['ate_m']}")
    return summary


def determinism_phase(sizes: Sizes) -> None:
    """Two ``tiny`` runs on the same inputs give bitwise-equal trajectories
    and maps."""
    scans, odom, gt = bench_sequence(sizes)
    run = _runner("tiny", sizes, gt[0])
    (t1, m1), (t2, m2) = (jax.block_until_ready(run(scans, odom)) for _ in range(2))
    same_t = np.array_equal(np.asarray(t1), np.asarray(t2))
    same_m = np.array_equal(np.asarray(m1), np.asarray(m2))
    report("determinism", preset="tiny", trajectory_bitwise=same_t, map_bitwise=same_m)
    check(same_t and same_m, "two tiny runs differ")


def memory_phase(sizes: Sizes) -> None:
    """``compiled.memory_analysis()`` of one ``tiny`` step."""
    cfg = tiny.tiny_config(map_size=sizes.map_size)
    scans, odom, _ = bench_sequence(sizes)
    scan = jax.tree.map(lambda a: a[0], scans)
    compiled = jax.jit(partial(eng.slam_step, cfg)).lower(
        eng.init_state(cfg), scan, odom[0]
    ).compile()
    report("memory", step="tiny.slam_step", analysis=str(compiled.memory_analysis()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded dry run on four GPUs")
    args = ap.parse_args(argv)
    compile_cache.enable()
    if args.four_cards:
        import __graft_entry__

        info = device_phase(4)
        t0 = time.perf_counter()
        __graft_entry__.dryrun_multichip(4)
        report("four_cards", dryrun_multichip_s=time.perf_counter() - t0)
    else:
        info = device_phase()
        sizes = Sizes()
        reference_phase(sizes)
        end_to_end_phase(sizes)
        summary = run_main_phase(sizes)
        report("run.main", **summary)
        determinism_phase(sizes)
        memory_phase(sizes)
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
