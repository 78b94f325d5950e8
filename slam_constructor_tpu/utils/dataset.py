"""Dataset readers: CARMEN logs (MIT Stata/CSAIL 2D-lidar format) with a
native C++ fast path and a pure-Python fallback.

Parity role (SURVEY.md §2.7): replaces the reference's ROS-side input stack
(``TopicWithTransform`` + ``LaserScanObserver``) with an offline aligned
(scan, odometry) stream: range filtering and fixed-width masking happen in
``to_sequence``, mirroring LaserScanObserver's policies.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np

from .. import native


def _load_native():
    """Build (once) and load the native parser; None if no toolchain."""
    path = native.build("carmen_parser.cpp", "libslamio.so")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.slamio_parse_carmen.restype = ctypes.c_void_p
    lib.slamio_parse_carmen.argtypes = [ctypes.c_char_p]
    lib.slamio_n_scans.argtypes = [ctypes.c_void_p]
    lib.slamio_n_beams.argtypes = [ctypes.c_void_p]
    lib.slamio_ranges.restype = ctypes.POINTER(ctypes.c_float)
    lib.slamio_ranges.argtypes = [ctypes.c_void_p]
    lib.slamio_odom.restype = ctypes.POINTER(ctypes.c_double)
    lib.slamio_odom.argtypes = [ctypes.c_void_p]
    lib.slamio_stamps.restype = ctypes.POINTER(ctypes.c_double)
    lib.slamio_stamps.argtypes = [ctypes.c_void_p]
    lib.slamio_meta.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.slamio_aux.restype = ctypes.c_char_p
    lib.slamio_aux.argtypes = [ctypes.c_void_p]
    lib.slamio_free.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None


def native_lib():
    global _LIB
    if _LIB is None:
        _LIB = _load_native() or False
    return _LIB or None


@dataclass
class CarmenLog:
    """Raw parsed log: per-scan ranges + odometry pose at scan time."""

    ranges: np.ndarray  # f32[T, R]
    odom_poses: np.ndarray  # f64[T, 3]
    timestamps: np.ndarray  # f64[T]
    start_angle: float = -math.pi / 2
    fov: float = math.pi
    max_range: float = 80.0
    #: PARAM records (raw strings, e.g. 'laser_front_laser_resolution')
    params: dict | None = None
    #: TRUEPOS ground-truth records, f64[N, 4] = (ts, x, y, theta), or None
    true_poses: np.ndarray | None = None

    @property
    def bearings(self) -> np.ndarray:
        r = self.ranges.shape[1]
        return (self.start_angle + self.fov * np.arange(r) / max(r - 1, 1)).astype(
            np.float32
        )

    def gt_at_scans(self) -> np.ndarray | None:
        """TRUEPOS ground truth resampled at scan timestamps (nearest
        record; CARMEN sim logs emit TRUEPOS at its own rate) — f32[T, 3]
        or None when the log carries no ground truth."""
        if self.true_poses is None or len(self.true_poses) == 0:
            return None
        ts = self.true_poses[:, 0]
        idx = np.clip(
            np.searchsorted(ts, self.timestamps), 0, len(ts) - 1
        )
        prev = np.maximum(idx - 1, 0)
        take_prev = np.abs(ts[prev] - self.timestamps) < np.abs(
            ts[idx] - self.timestamps
        )
        idx = np.where(take_prev, prev, idx)
        return self.true_poses[idx, 1:4].astype(np.float32)


def _parse_aux_lines(lines) -> tuple[dict, np.ndarray | None]:
    """Parse the rare non-laser records: PARAM key/values and TRUEPOS
    ground truth. The native parser collects these lines in its single
    pass (slamio_aux); the pure-Python fallback feeds the whole file."""
    params: dict = {}
    true_rows: list = []
    for line in lines:
        if line.startswith("PARAM"):
            t = line.split()
            if len(t) >= 3:
                params[t[1]] = t[2]
        elif line.startswith("TRUEPOS"):
            # TRUEPOS true_x true_y true_theta odom_x odom_y odom_theta
            #   ipc_ts host logger_ts
            t = line.split()
            if len(t) >= 8:
                true_rows.append(
                    [float(t[7]), float(t[1]), float(t[2]), float(t[3])]
                )
    tp = np.asarray(true_rows, np.float64) if true_rows else None
    return params, tp


def _scan_aux_records(path: str) -> tuple[dict, np.ndarray | None]:
    with open(path) as f:
        return _parse_aux_lines(f)


def read_carmen(path: str, prefer_native: bool = True) -> CarmenLog:
    """Parse FLASER/ROBOTLASER1 records from a CARMEN log file."""
    lib = native_lib() if prefer_native else None
    if lib is not None:
        h = lib.slamio_parse_carmen(path.encode())
        if h:
            try:
                t, r = lib.slamio_n_scans(h), lib.slamio_n_beams(h)
                if t > 0:
                    ranges = np.ctypeslib.as_array(
                        lib.slamio_ranges(h), shape=(t, r)
                    ).copy()
                    odom = np.ctypeslib.as_array(
                        lib.slamio_odom(h), shape=(t, 3)
                    ).copy()
                    ts = np.ctypeslib.as_array(lib.slamio_stamps(h), shape=(t,)).copy()
                    meta = (ctypes.c_double * 3)()
                    log = CarmenLog(ranges, odom, ts)
                    has_meta = bool(lib.slamio_meta(h, meta))
                    if has_meta:
                        log.start_angle, log.fov, log.max_range = (
                            meta[0], meta[1], meta[2],
                        )
                    aux = lib.slamio_aux(h).decode(errors="replace")
                    log.params, log.true_poses = _parse_aux_lines(
                        aux.splitlines()
                    )
                    _apply_params(log, geometry_from_records=has_meta)
                    return log
            finally:
                lib.slamio_free(h)
    return _read_carmen_py(path)


def _apply_params(log: CarmenLog, geometry_from_records: bool) -> None:
    """Fold PARAM-provided laser config into the log. FLASER records carry
    no geometry — classic logs declare it via PARAM lines; ROBOTLASER1
    records embed start_angle/fov/max_range, which win over PARAMs."""
    p = log.params or {}
    try:
        if geometry_from_records:
            return
        if "robot_front_laser_max" in p:
            log.max_range = float(p["robot_front_laser_max"])
        if "laser_front_laser_resolution" in p:
            res = math.radians(float(p["laser_front_laser_resolution"]))
            r = log.ranges.shape[1]
            fov = res * (r - 1)
            if 0 < fov <= 2 * math.pi:
                log.fov = fov
                log.start_angle = -fov / 2
    except ValueError:
        pass


def _read_carmen_py(path: str) -> CarmenLog:
    ranges, odom, ts = [], [], []
    meta = None
    n_beams = 0
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "FLASER":
                n = int(t[1])
                if n_beams == 0:
                    n_beams = n
                if n != n_beams or len(t) < 2 + n + 6:
                    continue
                ranges.append([float(v) for v in t[2 : 2 + n]])
                base = 2 + n
                odom.append([float(t[base + 3]), float(t[base + 4]), float(t[base + 5])])
                ts.append(float(t[base + 6]) if len(t) > base + 6 else len(ts))
            elif t[0] == "ROBOTLASER1":
                n = int(t[8])
                if n_beams == 0:
                    n_beams = n
                    meta = (float(t[2]), float(t[3]), float(t[5]))
                if n != n_beams or len(t) < 9 + n + 1:
                    continue
                nrem = int(t[9 + n])
                base = 9 + n + 1 + nrem
                if len(t) < base + 6:
                    continue
                ranges.append([float(v) for v in t[9 : 9 + n]])
                odom.append([float(t[base + 3]), float(t[base + 4]), float(t[base + 5])])
                ts.append(float(t[base + 11]) if len(t) > base + 11 else len(ts))
    log = CarmenLog(
        np.asarray(ranges, np.float32),
        np.asarray(odom, np.float64),
        np.asarray(ts, np.float64),
    )
    if meta:
        log.start_angle, log.fov, log.max_range = meta
    log.params, log.true_poses = _scan_aux_records(path)
    _apply_params(log, geometry_from_records=meta is not None)
    return log


def to_sequence(
    log: CarmenLog,
    min_range: float = 0.05,
    max_range: float | None = None,
    beam_stride: int = 1,
    scan_stride: int = 1,
):
    """CarmenLog -> (LaserScan [T, R], odom deltas f32[T, 3], gt=None).

    Odometry deltas are body-frame increments between consecutive scans
    (the reference's TransformedLaserScan pose delta).
    """
    import jax.numpy as jnp

    from ..ops.geometry import between
    from ..ops.scan import make_scan

    max_range = max_range if max_range is not None else min(log.max_range, 40.0)
    ranges = log.ranges[::scan_stride, ::beam_stride]
    bearings = log.bearings[::beam_stride]
    odom_poses = jnp.asarray(log.odom_poses[::scan_stride], jnp.float32)

    scans = make_scan(
        jnp.asarray(ranges),
        # batched [T, R] scan pytree (lax.scan needs a uniform leading axis)
        jnp.broadcast_to(jnp.asarray(bearings), ranges.shape),
        min_range,
        max_range,
    )
    deltas = between(odom_poses[:-1], odom_poses[1:])
    odom = jnp.concatenate([jnp.zeros((1, 3)), deltas], axis=0)
    return scans, odom.astype(jnp.float32), log.timestamps[::scan_stride]
