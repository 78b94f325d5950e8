"""Global relocalization: FFT cross-correlation over the whole map.

No direct reference counterpart (the reference's M3RSM searches a bounded
window); this is the capability extension for kidnapped-robot recovery and
loop-closure proposals at map scale, designed for the accelerator: for each candidate
rotation the scan's endpoint histogram is cross-correlated with the map's
occupancy value plane via zero-padded 2D FFTs — every translation in the
map scored in O(HW log HW), all rotations batched. The argmax seeds the
standard sub-cell refinement (hill climbing on the overlap reducer).

score(t) = sum_i v[c_i + t] == (h ⋆ v)[t], where h is the scatter histogram
of rotated endpoint cells — exactly the obstacle-reducer score times the
number of valid beams, so FFT scores and kernel scores agree up to fp error.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import scan as scanlib
from .geometry import wrap_angle
from .matchers import HillClimbingConfig, MatchResult, hill_climbing_match
from .scoring import MapView, ScoringConfig

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class RelocalizeConfig:
    n_theta: int = 32
    #: full heading sweep by default (kidnapped robot)
    half_theta: float = 3.14159265
    unknown_prob: float = 0.5
    refine_iterations: int = 10
    scoring: ScoringConfig = ScoringConfig(reducer="overlap")


def _fft_correlate(v: Array, h: Array) -> Array:
    """Cross-correlation (h ⋆ v) with zero padding (no circular aliasing).

    v, h: f32[H, W]. Returns f32[2H, 2W] where entry [H + ty, W + tx] is
    sum_rc h[r, c] * v[r + ty, c + tx].
    """
    hh, ww = v.shape
    vp = jnp.zeros((2 * hh, 2 * ww)).at[:hh, :ww].set(v)
    hp = jnp.zeros((2 * hh, 2 * ww)).at[:hh, :ww].set(h)
    fv = jnp.fft.rfft2(vp)
    fh = jnp.fft.rfft2(hp)
    corr = jnp.fft.irfft2(jnp.conj(fh) * fv, s=vp.shape)
    # corr[t mod 2H] = sum h[r] v[r + t]; negative t wrap to the top end
    return jnp.roll(corr, (hh, ww), axis=(0, 1))


def relocalize(
    view: MapView,
    scan: scanlib.LaserScan,
    cfg: RelocalizeConfig = RelocalizeConfig(),
    key: Array | None = None,
) -> MatchResult:
    """Find the best pose for ``scan`` ANYWHERE in the map."""
    del key
    h, w = view.occ.shape
    v = jnp.where(view.known, view.occ, 0.0)  # unknown contributes 0 evidence
    pts = scanlib.scan_points(scan)  # [R, 2] sensor frame
    valid = scan.valid

    thetas = jnp.linspace(
        -cfg.half_theta, cfg.half_theta, cfg.n_theta, endpoint=False
    )

    def per_theta(theta):
        c, s = jnp.cos(theta), jnp.sin(theta)
        ex = c * pts[:, 0] - s * pts[:, 1]
        ey = s * pts[:, 0] + c * pts[:, 1]
        # histogram endpoint cells relative to the map origin for a sensor
        # placed AT the origin corner; translation search covers the rest
        col = jnp.floor(ex / view.scale).astype(jnp.int32)
        row = jnp.floor(ey / view.scale).astype(jnp.int32)
        # shift into [0, H) histogram coords (scan spans +-max_range)
        row_h = row + h // 2
        col_h = col + w // 2
        ok = valid & (row_h >= 0) & (row_h < h) & (col_h >= 0) & (col_h < w)
        lin = jnp.where(ok, row_h * w + col_h, -1)
        hist = (
            jnp.zeros((h * w,)).at[lin].add(1.0, mode="drop").reshape(h, w)
        )
        corr = _fft_correlate(v, hist)  # [2H, 2W]
        best = jnp.argmax(corr)
        ty, tx = best // (2 * w), best % (2 * w)
        return corr.reshape(-1)[best], ty, tx

    scores, tys, txs = jax.vmap(per_theta)(thetas)
    bi = jnp.argmax(scores)
    theta = thetas[bi]
    # sensor cell position: histogram used origin-corner placement shifted
    # by (H/2, W/2); undo both shifts
    row0 = tys[bi] - h + h // 2
    col0 = txs[bi] - w + w // 2
    pose = jnp.stack(
        [
            view.origin[0] + (col0.astype(jnp.float32) + 0.5) * view.scale,
            view.origin[1] + (row0.astype(jnp.float32) + 0.5) * view.scale,
            wrap_angle(theta),
        ]
    )
    n_valid = jnp.maximum(valid.sum().astype(jnp.float32), 1.0)
    prob = scores[bi] / n_valid

    if cfg.refine_iterations > 0:
        hc = HillClimbingConfig(
            step_xy=view.scale,
            step_theta=float(2 * cfg.half_theta / cfg.n_theta / 2),
            iterations=cfg.refine_iterations,
            scoring=cfg.scoring,
        )
        return hill_climbing_match(view, scan, pose, None, hc, None)
    return MatchResult(pose=pose, prob=prob)
