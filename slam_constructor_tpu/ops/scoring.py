"""Scan-likelihood scoring: the hot kernel of the whole engine.

Parity targets (SURVEY.md §2.4 [unverified paths]):
- ``ScanProbabilityEstimator`` + ``WeightedMeanPointProbabilitySPE``
  (``src/core/scan_matchers/weighted_mean_point_probability_spe.h``)
- the four ``OccupancyObservationProbabilityEstimator`` reducers
  (obstacle / max / mean / overlap-weighted,
  ``src/core/scan_matchers/occupancy_observation_probability.h``)

Re-design: the reference scores ONE pose at a time, walking scan points and
doing pointer-chased per-cell virtual calls. Here the unit of work is
``score_poses(map, scan, poses[K]) -> probs[K]``: all K candidate poses, all
R beams, and the whole cell window are evaluated in one fused gather +
reduction — the shape every matcher (Monte-Carlo, hill-climbing, brute-force,
M3RSM) and the particle filter feed the device with.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import struct
from . import grid as gridlib
from . import scan as scanlib
from .geometry import apply_pose

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    #: 'obstacle' | 'max' | 'mean' | 'overlap'
    reducer: str = "obstacle"
    #: window radius in cells for max/mean/overlap reducers (1 -> 3x3)
    window: int = 1
    #: probability contributed by unknown / out-of-map cells (the SPE's
    #: unknown-cell handling knob)
    unknown_prob: float = 0.5
    #: use every stride-th beam (SPE skip policy)
    stride: int = 1
    #: side of the endpoint square for the overlap reducer, in cells
    overlap_extent: float = 1.0
    #: 'auto' | 'gather' | 'matmul'. 'auto' is the gather sampler on every
    #: backend. 'matmul' is an opt-in that samples the plane with separable
    #: one-hot / weighted one-hot matrix products instead (exact for
    #: obstacle/mean/overlap at f32; 'max' is not separable and keeps the
    #: gather).
    impl: str = "auto"
    #: matmul-path operand dtype: 'float32' (exact, default) or 'bfloat16'
    #: (accumulation stays fp32, per-point error ~0.4%, averaged scan
    #: scores shift <0.1%)
    dtype: str = "float32"


@struct.dataclass
class MapView:
    """Device-resident scoring view of a map: occupancy + known mask.

    Built once per matcher invocation (the map doesn't change while one
    scan is being matched) and reused across every score call.
    """

    occ: Array  # f32[H, W]
    known: Array  # bool[H, W]
    origin: Array  # f32[2]
    scale: float = struct.field(pytree_node=False)

    @classmethod
    def of(cls, gm: gridlib.GridMap, model) -> "MapView":
        return cls(
            occ=gridlib.occupancy_plane(gm, model),
            known=gridlib.known_mask(gm),
            origin=gm.origin,
            scale=gm.scale,
        )


def window_view(view: MapView, center_xy: Array, size: int) -> MapView:
    """Restrict a MapView to a ``size x size`` cell window around a world
    point (clamped to map bounds, jit-safe static output shape).

    Scoring-cost optimisation for local matchers: the matmul sampling
    path's FLOPs scale with the map area, but match candidates only ever land
    within a beam's reach of the prior pose. Cells outside the window score
    as ``unknown_prob`` — identical to the full view's treatment of
    out-of-map points, so a window that covers the scan footprint is exact.
    ``size >= map extent`` degenerates to the full view (bitwise equal).
    """
    h, w = view.occ.shape
    sh, sw = min(size, h), min(size, w)
    rel = (center_xy - view.origin) / view.scale  # fractional (x, y)
    col = jnp.clip(jnp.floor(rel[0]).astype(jnp.int32) - sw // 2, 0, w - sw)
    row = jnp.clip(jnp.floor(rel[1]).astype(jnp.int32) - sh // 2, 0, h - sh)
    occ = jax.lax.dynamic_slice(view.occ, (row, col), (sh, sw))
    known = jax.lax.dynamic_slice(view.known, (row, col), (sh, sw))
    origin = view.origin + jnp.stack([col, row]).astype(jnp.float32) * view.scale
    return MapView(occ=occ, known=known, origin=origin, scale=view.scale)


def window_view_onehot(view: MapView, center_xy: Array, size: int) -> MapView:
    """`window_view` with the extraction done by separable one-hot f32
    matmuls instead of dynamic_slice.

    Bitwise-equal output (one-hot f32 matmuls at HIGHEST precision are
    exact). Under ``vmap`` over particles a traced-offset ``dynamic_slice``
    lowers to P window gathers, while this form is one batched matmul.
    Same trick as ``gmapping.insert_impl='onehot'``.
    """
    h, w = view.occ.shape
    sh, sw = min(size, h), min(size, w)
    rel = (center_xy - view.origin) / view.scale
    col = jnp.clip(jnp.floor(rel[0]).astype(jnp.int32) - sw // 2, 0, w - sw)
    row = jnp.clip(jnp.floor(rel[1]).astype(jnp.int32) - sh // 2, 0, h - sh)
    er = ((row + jnp.arange(sh))[:, None] == jnp.arange(h)[None, :]).astype(
        jnp.float32
    )  # [sh, H]
    ec = ((col + jnp.arange(sw))[:, None] == jnp.arange(w)[None, :]).astype(
        jnp.float32
    )  # [sw, W]
    # precision pinned: bitwise extraction must not depend on the backend's
    # default matmul precision truncating the map operand (TF32 on GPUs)
    hi = jax.lax.Precision.HIGHEST
    occ = jnp.einsum(
        "sw,rw->rs", ec, jnp.einsum("rh,hw->rw", er, view.occ, precision=hi),
        precision=hi,
    )
    known_f = jnp.einsum(
        "sw,rw->rs", ec,
        jnp.einsum(
            "rh,hw->rw", er, view.known.astype(jnp.float32), precision=hi
        ),
        precision=hi,
    )
    origin = view.origin + jnp.stack([col, row]).astype(jnp.float32) * view.scale
    return MapView(
        occ=occ, known=known_f > 0.5, origin=origin, scale=view.scale
    )


def _window_offsets(radius: int) -> Array:
    r = jnp.arange(-radius, radius + 1)
    return jnp.stack(jnp.meshgrid(r, r, indexing="ij"), axis=-1).reshape(-1, 2)


# --- matmul sampling path ---------------------------------------------------
#
# Sampling N plane values is recast as  val = (A @ plane) . B  where A
# [N, H] and B [N, W] hold per-axis selection weights (a one-hot row for
# point sampling, a box for mean windows, fractional cell-overlap lengths
# for the area/bilinear reducer). The footprints are separable, so the 2D
# weight is the outer product a_r * b_c — one [N, H] x [H, W] matmul plus an
# elementwise row dot replaces the random gather. Out-of-map weight mass is
# accounted by coverage = sum(a) * sum(b) and backfilled with unknown_prob,
# matching the gather path's out-of-bounds semantics bit-for-bit in fp32.


def _axis_weights_point(pos: Array, n: int) -> Array:
    """One-hot rows: weight 1 at floor(pos) if inside [0, n)."""
    i = jnp.floor(pos).astype(jnp.int32)
    iota = jnp.arange(n)
    return ((i[:, None] == iota[None, :])).astype(jnp.float32)


def _axis_weights_box(pos: Array, n: int, radius: int) -> Array:
    """Box rows: weight 1 at floor(pos)-r .. floor(pos)+r, clipped to bounds."""
    i = jnp.floor(pos).astype(jnp.int32)
    iota = jnp.arange(n)
    d = iota[None, :] - i[:, None]
    return ((d >= -radius) & (d <= radius)).astype(jnp.float32)


def _axis_weights_overlap(pos: Array, n: int, extent: float) -> Array:
    """Cell-overlap lengths of the interval [pos-e/2, pos+e/2) per axis."""
    iota = jnp.arange(n, dtype=jnp.float32)
    lo = jnp.maximum(iota[None, :], pos[:, None] - extent / 2.0)
    hi = jnp.minimum(iota[None, :] + 1.0, pos[:, None] + extent / 2.0)
    return jnp.clip(hi - lo, 0.0)


def _sample_matmul(
    v: Array, rel: Array, cfg: "ScoringConfig"
) -> Array:
    """Per-point probabilities [N] for flat fractional coords rel [N, 2]."""
    h, w = v.shape
    x, y = rel[:, 0], rel[:, 1]
    if cfg.reducer == "obstacle":
        a = _axis_weights_point(y, h)
        b = _axis_weights_point(x, w)
        total = 1.0
    elif cfg.reducer == "mean":
        a = _axis_weights_box(y, h, cfg.window)
        b = _axis_weights_box(x, w, cfg.window)
        total = float((2 * cfg.window + 1) ** 2)
    elif cfg.reducer == "overlap":
        a = _axis_weights_overlap(y, h, cfg.overlap_extent)
        b = _axis_weights_overlap(x, w, cfg.overlap_extent)
        total = float(cfg.overlap_extent**2)
    else:
        raise ValueError(f"no matmul path for reducer {cfg.reducer!r}")
    if cfg.dtype == "bfloat16":
        a = a.astype(jnp.bfloat16)
        v = v.astype(jnp.bfloat16)
        prec = None  # operands already bf16; precision is moot
    else:
        # f32 path is bitwise-equal to the gather path for the one-hot
        # reducers — pin precision so that holds whatever the backend's
        # default matmul precision (TF32 on NVIDIA GPUs)
        prec = jax.lax.Precision.HIGHEST
    m = jnp.dot(a, v, preferred_element_type=jnp.float32, precision=prec)  # [N, W]
    ssum = (m * b).sum(-1)
    coverage = a.sum(-1) * b.sum(-1)
    val = ssum + (total - coverage) * cfg.unknown_prob
    return val / total


_MATMUL_CHUNK = 8192
_MATMUL_BYTES = 8 << 20  # [chunk, H] selection-operand budget


def _sample_matmul_chunked(v: Array, rel: Array, cfg: "ScoringConfig") -> Array:
    """Chunked wrapper bounding the [N, H] one-hot working set.

    The chunk adapts to the plane height: windowed views (small H) admit
    proportionally larger chunks — fewer serial lax.map steps for big
    candidate batches — while the full-map floor stays at the tuned 8192
    rows (~8 MB selection operand at H=256)."""
    n = rel.shape[0]
    chunk = max(_MATMUL_CHUNK, _MATMUL_BYTES // max(4 * v.shape[0], 1))
    if n <= chunk:
        return _sample_matmul(v, rel, cfg)
    pad = (-n) % chunk
    rel_p = jnp.concatenate([rel, jnp.zeros((pad, 2), rel.dtype)], 0)
    chunks = rel_p.reshape(-1, chunk, 2)
    out = jax.lax.map(lambda r: _sample_matmul(v, r, cfg), chunks)
    return out.reshape(-1)[:n]


# NOTE: a per-beam windowed scoring path ("beam windows": gather a BxB
# window around every beam endpoint once per matcher round, then score
# candidates against the stack) was built and deleted: the R-way
# vmap(dynamic_slice) window gather made it an end-to-end regression. The
# surviving reduction is :func:`window_view` — ONE robot-centered dynamic
# slice per match, which shrinks H, W to the window. See DESIGN.md "Beam
# windows post-mortem".


def _strided_scan(scan: scanlib.LaserScan, stride: int) -> scanlib.LaserScan:
    return scanlib.LaserScan(
        ranges=scan.ranges[::stride],
        bearings=scan.bearings[::stride],
        valid=scan.valid[::stride],
    )


def score_poses(
    view: MapView,
    scan: scanlib.LaserScan,
    poses: Array,
    cfg: ScoringConfig = ScoringConfig(),
    point_weights: Array | None = None,
) -> Array:
    """Score candidate poses against the map.

    poses: f32[K, 3] -> returns f32[K] mean per-point consistency
    probability in [0, 1] (the reference SPE's scan probability).
    ``point_weights`` optionally reweights beams (vinySLAM uses the angle
    histogram to down-weight degenerate directions).
    """
    h, w = view.occ.shape
    if cfg.stride > 1:
        # slice beams BEFORE sampling: the strided weighted mean over the
        # kept beams is bitwise the masked mean (subsample_mask keeps
        # idx % stride == 0, exactly the [::stride] slice) while the
        # sampling work — the dominant matmul — shrinks by the stride.
        scan = _strided_scan(scan, cfg.stride)
        if point_weights is not None:
            point_weights = point_weights[:: cfg.stride]
        cfg = dataclasses.replace(cfg, stride=1)
    pts = scanlib.scan_points(scan)  # [R, 2] sensor frame
    world = apply_pose(poses[:, None, :], pts[None, :, :])  # [K, R, 2]
    rel = (world - view.origin) / view.scale  # fractional cell coords

    if cfg.impl == "matmul":
        k, r = rel.shape[:2]
        v = jnp.where(view.known, view.occ, cfg.unknown_prob)
        point_p = _sample_matmul_chunked(v, rel.reshape(k * r, 2), cfg)
        point_p = point_p.reshape(k, r)
        return _weighted_mean(point_p, scan, cfg, point_weights)

    base = jnp.floor(rel).astype(jnp.int32)  # [K, R, 2] (col-major: x, y)
    # convert to (row, col)
    base_rc = jnp.stack([base[..., 1], base[..., 0]], axis=-1)

    if cfg.reducer == "obstacle":
        idx = base_rc[:, :, None, :]  # [K, R, 1, 2]
    else:
        offs = _window_offsets(cfg.window)  # [W2, 2]
        idx = base_rc[:, :, None, :] + offs[None, None, :, :]

    occ = gridlib.gather_plane(view.occ, idx, cfg.unknown_prob, h, w)
    known = gridlib.gather_plane(
        view.known.astype(jnp.float32), idx, 0.0, h, w
    )
    vals = jnp.where(known > 0, occ, cfg.unknown_prob)  # [K, R, W2]

    if cfg.reducer in ("obstacle",):
        point_p = vals[..., 0]
    elif cfg.reducer == "max":
        point_p = vals.max(axis=-1)
    elif cfg.reducer == "mean":
        point_p = vals.mean(axis=-1)
    elif cfg.reducer == "overlap":
        # overlap of the endpoint square (side overlap_extent cells) with
        # each window cell, in cell units — closed form from frac coords
        offs = _window_offsets(cfg.window).astype(jnp.float32)
        frac = rel - jnp.floor(rel)  # [K, R, 2] (x, y) in [0,1)
        half = cfg.overlap_extent / 2.0
        # endpoint square in cell coords, relative to the base cell corner
        exy = frac[:, :, None, :]  # x, y
        cell_lo = jnp.stack([offs[..., 1], offs[..., 0]], axis=-1)  # (x, y)
        lo = jnp.maximum(cell_lo[None, None], exy - half)
        hi = jnp.minimum(cell_lo[None, None] + 1.0, exy + half)
        wh = jnp.clip(hi - lo, 0.0)
        wgt = wh[..., 0] * wh[..., 1]  # [K, R, W2]
        wsum = jnp.maximum(wgt.sum(-1, keepdims=True), 1e-9)
        point_p = (vals * wgt).sum(-1) / wsum[..., 0]
    else:
        raise ValueError(f"unknown reducer {cfg.reducer!r}")

    return _weighted_mean(point_p, scan, cfg, point_weights)


def _weighted_mean(point_p, scan, cfg, point_weights):
    mask = scanlib.subsample_mask(scan, cfg.stride).astype(jnp.float32)
    if point_weights is not None:
        mask = mask * point_weights
    mask = mask[None, :]
    return (point_p * mask).sum(-1) / jnp.maximum(mask.sum(-1), 1e-9)


def score_single(view, scan, pose, cfg=ScoringConfig(), point_weights=None):
    return score_poses(view, scan, pose[None, :], cfg, point_weights)[0]


def estimate_information(
    view: MapView,
    scan: scanlib.LaserScan,
    pose: Array,
    cfg: ScoringConfig = ScoringConfig(),
    eps: tuple = (0.04, 0.04, 0.02),
) -> Array:
    """Diagonal information (inverse covariance) of a match from the local
    curvature of the score surface at ``pose``.

    Central second differences per axis (one batched 7-pose score call);
    the score (mean per-beam probability) is scaled by the valid-beam count
    to approximate a log-likelihood, so sharper peaks and denser scans both
    raise confidence. Negative curvature directions (degenerate, e.g. along
    a corridor) floor at a small positive value — exactly the axes a
    pose-graph solver should trust least.
    """
    e = jnp.asarray(eps, jnp.float32)
    offs = jnp.concatenate(
        [jnp.zeros((1, 3)), jnp.diag(e), -jnp.diag(e)], axis=0
    )  # [7, 3]
    probs = score_poses(view, scan, pose[None, :] + offs, cfg)
    s0, sp, sm = probs[0], probs[1:4], probs[4:7]
    curv = -(sp - 2.0 * s0 + sm) / (e * e)  # positive at a peak
    n = jnp.maximum(scan.valid.sum().astype(jnp.float32), 1.0)
    info = n * curv / jnp.maximum(s0, 1e-3)
    return jnp.clip(info, 1.0, 1e5)
