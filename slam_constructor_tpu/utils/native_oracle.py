"""ctypes loader for the native cross-validation oracles
(native/score_oracle.cpp). Test-facing; returns None without a toolchain."""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native

_cache = None


def lib():
    global _cache
    if _cache is not None:
        return _cache or None
    path = native.build("score_oracle.cpp", "libslamscore.so")
    if path is None:
        _cache = False
        return None
    try:
        l = ctypes.CDLL(path)
    except OSError:
        _cache = False
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    l.slamscore_obstacle.restype = ctypes.c_float
    l.slamscore_obstacle.argtypes = [
        f32p, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, f32p, u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ]
    l.slamscore_compose.argtypes = [f32p, f32p, f32p]
    _cache = l
    return l


def score_obstacle(view, scan, pose, unknown_prob=0.5, stride=1):
    """C++ oracle score (obstacle reducer); None if no native lib."""
    l = lib()
    if l is None:
        return None
    occ = np.ascontiguousarray(np.asarray(view.occ), np.float32)
    known = np.ascontiguousarray(np.asarray(view.known), np.uint8)
    ranges = np.ascontiguousarray(np.asarray(scan.ranges), np.float32)
    bearings = np.ascontiguousarray(np.asarray(scan.bearings), np.float32)
    valid = np.ascontiguousarray(np.asarray(scan.valid), np.uint8)
    origin = np.asarray(view.origin)
    p = np.asarray(pose, np.float32)
    return float(
        l.slamscore_obstacle(
            occ, known, occ.shape[0], occ.shape[1],
            float(origin[0]), float(origin[1]), float(view.scale),
            float(unknown_prob),
            ranges, bearings, valid, len(ranges),
            int(stride), float(p[0]), float(p[1]), float(p[2]),
        )
    )


def compose(a, b):
    l = lib()
    if l is None:
        return None
    out = np.zeros(3, np.float32)
    l.slamscore_compose(
        np.ascontiguousarray(a, np.float32),
        np.ascontiguousarray(b, np.float32), out,
    )
    return out
