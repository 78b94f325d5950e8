"""Laser-scan containers and preprocessing.

Parity with the reference's sensor-data layer (``ScanPoint2D``,
``LaserScan2D``, ``TransformedLaserScan`` in ``src/core/states/sensor_data.h``
and the range filtering of ``src/ros/laser_scan_observer.h`` [unverified,
SURVEY.md §2.2/§2.7]) — re-expressed as fixed-width arrays with validity
masks so every scan has a static shape under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import struct

Array = jax.Array


@struct.dataclass
class LaserScan:
    """A single 2D scan in the sensor frame.

    ranges:   f32[R]  measured ranges (meters); garbage where ``valid`` is 0
    bearings: f32[R]  beam angles (radians, sensor frame)
    valid:    bool[R] range inside [min_range, max_range] and finite
    """

    ranges: Array
    bearings: Array
    valid: Array

    @property
    def n_beams(self) -> int:
        return self.ranges.shape[-1]


@struct.dataclass
class OdomScan:
    """A scan plus the odometry pose delta since the previous scan
    (reference: ``TransformedLaserScan`` = scan + ``RobotPoseDelta`` +
    quality)."""

    scan: LaserScan
    odom_delta: Array  # f32[3] body-frame pose increment
    quality: Array  # f32[] confidence in [0, 1]


def make_scan(
    ranges: Array,
    bearings: Array,
    min_range: float = 0.05,
    max_range: float = 15.0,
) -> LaserScan:
    """Build a scan with validity mask (the LaserScanObserver filter)."""
    ranges = jnp.asarray(ranges, jnp.float32)
    bearings = jnp.asarray(bearings, jnp.float32)
    valid = (
        jnp.isfinite(ranges) & (ranges >= min_range) & (ranges <= max_range)
    )
    return LaserScan(
        ranges=jnp.where(valid, ranges, max_range),
        bearings=bearings,
        valid=valid,
    )


def scan_points(scan: LaserScan) -> Array:
    """Sensor-frame cartesian endpoints ``f32[R, 2]`` (cached trig in the
    reference's ScanPoint2D; here it's just fused into the jit)."""
    c, s = jnp.cos(scan.bearings), jnp.sin(scan.bearings)
    return jnp.stack([scan.ranges * c, scan.ranges * s], axis=-1)


def subsample_mask(scan: LaserScan, stride: int) -> Array:
    """Validity mask with every ``stride``-th beam kept (the SPE
    ``skip_beams`` knob of WeightedMeanPointProbabilitySPE)."""
    if stride <= 1:
        return scan.valid
    idx = jnp.arange(scan.n_beams)
    return scan.valid & (idx % stride == 0)


def angle_histogram(scan: LaserScan, n_bins: int = 36) -> Array:
    """Histogram of consecutive-endpoint direction angles (vinySLAM's scan
    degeneracy feature, reference ``AngleHistogram`` [unverified]).

    Returns normalized bin weights ``f32[n_bins]``.
    """
    pts = scan_points(scan)
    d = pts[1:] - pts[:-1]
    ang = jnp.arctan2(d[..., 1], d[..., 0])  # (-pi, pi]
    ok = (scan.valid[1:] & scan.valid[:-1]).astype(jnp.float32)
    bins = jnp.floor((ang + jnp.pi) / (2 * jnp.pi) * n_bins).astype(jnp.int32)
    bins = jnp.clip(bins, 0, n_bins - 1)
    hist = jnp.zeros((n_bins,), jnp.float32).at[bins].add(ok)
    return hist / jnp.maximum(hist.sum(), 1.0)
