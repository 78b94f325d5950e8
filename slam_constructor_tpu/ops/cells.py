"""Grid-cell belief models: Bayesian (tinySLAM) and Transferable Belief
Model (vinySLAM).

Parity with the reference's cell-model layer (SURVEY.md §2.3/§2.6:
``GridCell``/``Occupancy`` in ``src/core/maps/grid_cell.h``; ``BaseTinyCell``
/ ``AvgTinyCell`` in ``src/slams/tiny/tiny_grid_cell.h``; the TBM cell of
``src/slams/viny/viny_grid_cell.h`` [unverified]).

Re-design for the accelerator: the reference updates one heap-allocated cell object per
beam via virtual ``operator+=``; here a whole scan's observations are first
scatter-accumulated into two dense planes — per-cell observation weight
``w`` and weight-summed observed occupancy ``s`` — and the model then applies
a closed-form *w-fold* update to every cell at once (one fused elementwise
pass). For homogeneous per-cell observations within one scan this is
exactly k sequential reference updates; mixed free/hit observations of one
cell in one scan are merged through their weighted mean, which is the scheme's
only (benign, sub-resolution) approximation.

Models are static (hashable) Python dataclasses — config-chosen at trace
time, zero runtime dispatch.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

Array = jax.Array

_EPS = 1e-9


def _mean_obs(w: Array, s: Array) -> Array:
    return s / jnp.maximum(w, _EPS)


def init_cell(model) -> Array:
    """The stored cell vector for an untouched cell: model init belief +
    a zero weight channel (shared by every block/pool storage)."""
    return jnp.concatenate(
        [jnp.asarray(model.init_belief(), jnp.float32), jnp.zeros((1,))]
    )


@dataclasses.dataclass(frozen=True)
class BayesBaseCell:
    """tinySLAM's base cell: exponential smoothing toward the observation,
    ``p <- (1-q) p + q p_obs`` (reference ``BaseTinyCell``). A weight-w
    batch of identical observations folds to
    ``p <- (1-q)^w p + (1 - (1-q)^w) mean_obs`` (exact for integer w)."""

    quality: float = 0.5

    n_channels: int = dataclasses.field(default=1, init=False)

    def init_belief(self):
        return (0.5,)

    def update(self, belief: Array, n_prev: Array, w: Array, s: Array) -> Array:
        keep = jnp.power(1.0 - self.quality, w)
        p = keep * belief[..., 0] + (1.0 - keep) * _mean_obs(w, s)
        p = jnp.where(w > 0, p, belief[..., 0])
        return p[..., None]

    def occupancy(self, belief: Array) -> Array:
        return belief[..., 0]


@dataclasses.dataclass(frozen=True)
class BayesAvgCell:
    """tinySLAM's averaging cell (reference ``AvgTinyCell``): running
    weighted mean of observed occupancy, exact for fractional weights:
    ``p <- (p n + s) / (n + w)``."""

    n_channels: int = dataclasses.field(default=1, init=False)
    #: folding (w1, s1) then (w2, s2) equals folding (w1+w2, s1+s2): the
    #: belief is a pure weighted mean, so observation planes from MANY
    #: scans may be summed and applied in ONE update (exact up to fp
    #: summation order). Lets the pose graph rasterize keyframes in
    #: parallel (vmap) instead of a serial insert chain. False for the
    #: exp-smoothing and TBM models, whose folds are order-sensitive.
    fold_additive: bool = dataclasses.field(default=True, init=False)

    def init_belief(self):
        return (0.5,)

    def update(self, belief: Array, n_prev: Array, w: Array, s: Array) -> Array:
        p = (belief[..., 0] * n_prev + s) / jnp.maximum(n_prev + w, _EPS)
        p = jnp.where(n_prev + w > 0, p, belief[..., 0])
        return p[..., None]

    def occupancy(self, belief: Array) -> Array:
        return belief[..., 0]


@dataclasses.dataclass(frozen=True)
class TBMCell:
    """vinySLAM's Transferable-Belief-Model cell: belief masses over the
    frame {occupied, empty} — channels ``[m_occ, m_emp, m_unknown,
    m_conflict]`` — combined per observation with the unnormalized
    conjunctive (Dempster) rule; conflict mass absorbs dynamic objects.

    An observation with estimated occupancy ``o`` and sensor quality ``q``
    induces the simple mass function ``(q·o, q·(1-o), 1-q, 0)``. Observation
    weight w applies ``floor(w)`` full conjunctive rounds IN CLOSED FORM
    plus one partial round at quality ``q·frac(w)`` (smooth in w): one
    round is linear and triangular in the state —

        mu' = mu·uu;  mo' = mo·(oo+uu) + mu·oo;  me' = me·(ee+uu) + mu·ee

    so k identical rounds solve to the power form

        mu_k = mu·uu^k
        mo_k = mo·(oo+uu)^k + mu·((oo+uu)^k − uu^k)
        me_k = me·(ee+uu)^k + mu·((ee+uu)^k − uu^k)
        mx_k = total − mo_k − me_k − mu_k   (total mass is conserved)

    exact for ANY w — near-sensor cells crossed by many beams per scan
    (w ≫ 1) lose no evidence (round 1 capped the loop at 4 rounds).
    ``conflict_decay`` moves a fraction of conflict mass back to unknown
    after each update (vinySLAM's dynamic-object forgetting).
    Occupancy readout is the pignistic transform with conflict split evenly.
    """

    quality: float = 0.4
    conflict_decay: float = 0.1

    n_channels: int = dataclasses.field(default=4, init=False)

    def init_belief(self):
        return (0.0, 0.0, 1.0, 0.0)

    def update(self, belief: Array, n_prev: Array, w: Array, s: Array) -> Array:
        o = _mean_obs(w, s)
        q = self.quality
        k = jnp.floor(w)
        frac = w - k

        # closed form for k = floor(w) full rounds
        oo, ee, uu = q * o, q * (1.0 - o), 1.0 - q

        def powk(base):
            # base^k for traced k >= 0 and base in [0, 1]; exp(0·log(eps))=1
            # keeps the k=0 identity even when base == 0 (q == 1)
            return jnp.exp(k * jnp.log(jnp.maximum(base, _EPS)))

        mo, me, mu, mx = belief[..., 0], belief[..., 1], belief[..., 2], belief[..., 3]
        total = mo + me + mu + mx
        pu = powk(uu)
        po = powk(oo + uu)
        pe = powk(ee + uu)
        mo = mo * po + mu * (po - pu)
        me = me * pe + mu * (pe - pu)
        mu = mu * pu
        mx = jnp.maximum(total - mo - me - mu, 0.0)

        # one partial round at quality q·frac (identity when frac == 0)
        qi = q * frac
        oo, ee, uu = qi * o, qi * (1.0 - o), 1.0 - qi
        no = mo * (oo + uu) + mu * oo
        ne = me * (ee + uu) + mu * ee
        nu = mu * uu
        nx = mx * (oo + ee + uu) + mo * ee + me * oo
        m = jnp.stack([no, ne, nu, nx], axis=-1)

        # conflict forgetting
        mo, me, mu, mx = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        mu = mu + self.conflict_decay * mx * (w > 0)
        mx = mx * jnp.where(w > 0, 1.0 - self.conflict_decay, 1.0)
        m = jnp.stack([mo, me, mu, mx], axis=-1)
        # renormalize (guards fp drift; masses stay a partition of unity)
        m = m / jnp.maximum(m.sum(-1, keepdims=True), _EPS)
        return jnp.where((w > 0)[..., None], m, belief)

    def occupancy(self, belief: Array) -> Array:
        mo, mu, mx = belief[..., 0], belief[..., 2], belief[..., 3]
        return mo + 0.5 * mu + 0.5 * mx


#: registry for the config system (reference: init_utils factories choosing
#: the cell type from a properties key — SURVEY.md §2.7/§2.8)
CELL_MODELS = {
    "bayes_base": BayesBaseCell,
    "bayes_avg": BayesAvgCell,
    "tbm": TBMCell,
}
