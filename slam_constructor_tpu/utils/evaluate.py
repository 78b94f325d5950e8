"""Trajectory evaluation: ATE and RPE (TUM-benchmark style).

The reference evaluates offline with the TUM scripts against MIT
Stata/CSAIL ground truth (SURVEY.md §4/§6); here the evaluator is built in
so synthetic-sequence tests and benches report the same headline metric.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.geometry import between, wrap_angle

Array = jax.Array
#: full f32 products: TF32 (the GPU default) would move 10 m poses by ~1 cm
_HI = jax.lax.Precision.HIGHEST


def align_2d(est_xy: Array, gt_xy: Array) -> tuple[Array, Array]:
    """Closed-form 2D similarity-free (rigid) alignment: rotation + translation
    minimizing RMSE (2D Umeyama/Kabsch). Returns (R 2x2, t 2)."""
    mu_e = est_xy.mean(0)
    mu_g = gt_xy.mean(0)
    e = est_xy - mu_e
    g = gt_xy - mu_g
    # cross-covariance
    sxx = (e[:, 0] * g[:, 0]).sum()
    syy = (e[:, 1] * g[:, 1]).sum()
    sxy = (e[:, 0] * g[:, 1]).sum()
    syx = (e[:, 1] * g[:, 0]).sum()
    theta = jnp.arctan2(sxy - syx, sxx + syy)
    c, s = jnp.cos(theta), jnp.sin(theta)
    rot = jnp.array([[c, -s], [s, c]])
    t = mu_g - jnp.matmul(rot, mu_e, precision=_HI)
    return rot, t


def ate(est: Array, gt: Array, align: bool = True) -> Array:
    """Absolute trajectory error (RMSE over positions), optionally after
    rigid alignment. est/gt: f32[T, 3] poses."""
    e, g = est[:, :2], gt[:, :2]
    if align:
        rot, t = align_2d(e, g)
        e = jnp.matmul(e, rot.T, precision=_HI) + t
    return jnp.sqrt(((e - g) ** 2).sum(-1).mean())


def map_quality(
    occ_est: Array,
    occ_gt: Array,
    occupied_thresh: float = 0.6,
    free_thresh: float = 0.25,
) -> dict:
    """Map-vs-ground-truth metrics on co-registered occupancy planes:
    occupied-cell IoU, free-space accuracy, and coverage (fraction of
    ground-truth structure observed). Planes must share extent/scale."""
    est_occ = occ_est >= occupied_thresh
    est_free = occ_est <= free_thresh
    gt_occ = occ_gt >= 0.5
    inter = jnp.logical_and(est_occ, gt_occ).sum()
    union = jnp.logical_or(est_occ, gt_occ).sum()
    iou = inter / jnp.maximum(union, 1)
    # of the cells the map claims free, how many are truly free
    free_acc = jnp.logical_and(est_free, ~gt_occ).sum() / jnp.maximum(
        est_free.sum(), 1
    )
    coverage = inter / jnp.maximum(gt_occ.sum(), 1)
    return {
        "occupied_iou": float(iou),
        "free_accuracy": float(free_acc),
        "coverage": float(coverage),
    }


def rpe(est: Array, gt: Array, delta: int = 1) -> tuple[Array, Array]:
    """Relative pose error over ``delta``-step increments.
    Returns (rmse_translation, rmse_rotation)."""
    de = between(est[:-delta], est[delta:])
    dg = between(gt[:-delta], gt[delta:])
    dt = de[:, :2] - dg[:, :2]
    dr = wrap_angle(de[:, 2] - dg[:, 2])
    return (
        jnp.sqrt((dt**2).sum(-1).mean()),
        jnp.sqrt((dr**2).mean()),
    )
