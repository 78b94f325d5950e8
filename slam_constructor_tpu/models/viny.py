"""vinySLAM preset (Huletski, Kartashov & Krinkin, IROS 2017).

Parity: the reference's ``src/slams/viny/`` node (SURVEY.md §2.6
[unverified]): Transferable-Belief-Model cells with conjunctive
combination + conflict handling, area occupancy estimator, improved
matching with scan-degeneracy weighting and quality-gated insertion.
"""

from __future__ import annotations

from ..ops import cells, matchers, raycast, scoring
from .engine import Engine, EngineConfig


def viny_config(
    quality: float = 0.5,
    conflict_decay: float = 0.1,
    map_size: int = 256,
    map_scale: float = 0.1,
    hole_width: float = 0.3,
    mc_batch: int = 64,
    mc_rounds: int = 16,
    min_insert_prob: float = 0.0,
    use_angle_histogram: bool = True,
    scoring_cfg: scoring.ScoringConfig | None = None,
    stride: int = 2,
) -> EngineConfig:
    """``stride``: matcher beam subsampling (the reference SPE's skip
    knob). Default 2: at 360-beam scans the 5-seed 2-lap ATE is
    indistinguishable from stride 1 (0.1180/0.1175 mean vs 0.1178/0.1169
    at bench / 2x odometry noise) for half the scoring work. For sparse
    scans (<=120 beams) prefer stride=1 — the single-hypothesis matcher
    has no particle diversity to absorb a lossy score (see
    tiny.fast_config docstring)."""
    if scoring_cfg is None:
        scoring_cfg = scoring.ScoringConfig(
            reducer="overlap", window=1, stride=stride)
    return EngineConfig(
        cell_model=cells.TBMCell(quality=quality, conflict_decay=conflict_decay),
        matcher="monte_carlo",
        matcher_cfg=matchers.MonteCarloConfig(
            sigma_xy=0.08,
            sigma_theta=0.05,
            batch=mc_batch,
            rounds=mc_rounds,
            scoring=scoring_cfg,
        ),
        # const endpoint evidence + symmetric wall blur tracks best with
        # TBM cells (the area estimator's fractional weights under-evidence
        # walls against the strong free-space counts); 'area' remains a
        # config choice for the estimator-parity matrix
        beam=raycast.BeamConfig(
            occupancy_estimator="const", hole_width=hole_width, wall_blur=True,
            free_impl="dda",
        ),
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
        min_insert_prob=min_insert_prob,
        use_angle_histogram=use_angle_histogram,
    )


def make_engine(**kwargs) -> Engine:
    return Engine(viny_config(**kwargs))


def viny_m3rsm_config(
    map_size: int = 256,
    map_scale: float = 0.1,
    usable_range: float = 5.0,
    quality: float = 0.5,
    hole_width: float = 0.3,
    levels: int = 4,
    n_theta: int = 9,
    beam_width: int = 48,
    half_xy: float = 0.6,
    half_theta: float = 0.2,
    stride: int = 2,
    use_angle_histogram: bool = True,
    reducer: str = "overlap",
) -> EngineConfig:
    """vinySLAM + the M3RSM global matcher: usable-range-capped beams
    (GMapping's maxUrange discipline, shared with gmapping.fast_config)
    + a prior-centered search window sized so the windowed level scoring
    is EXACT (M3RSMConfig.window doc).

    Two constraints fix this operating point:
    1. Config: usable_range=4, reducer='obstacle' or stride=1 fail —
       range 4 diverges with any scoring (the cecum loop needs >= 6 m of
       reach at overlap) and the 'obstacle' point-sample reducer costs
       0.376 vs 0.071 m ATE at range 8. Fixed point: overlap reducer +
       stride 2 + range >= 5.
    2. Insert algorithm: the free fill must be the per-beam DDA. The
       dense polar fill's wall-halo erosion aliases the global B&B (5-seed
       ATE 3.8-5.2 m against 0.07 m with DDA on the same config).

    Operating point: usable_range=5 + beam_width=48 + n_theta=9. On the
    smoke sequence (512 scans over 0.7 lap of the cecum world, 360 beams,
    256^2 at 0.1 m, odometry noise 0.01 m / 0.005 rad) it is bimodal: on
    the CPU 4 of 5 noise seeds read ATE 0.127-0.128 m (the error grows to
    ~0.16 m between scans ~200 and ~450, then recovers) and one reads
    0.072 m; an NVIDIA H100 (700 W limit) reads 0.1281 m on seed 0. The
    B&B frontier is not the quality constraint at these shapes:
    beam_width 32-96 gave identical ATE on every seed (48 keeps one notch
    of margin over the narrowest measured point). Rejected levers, each
    by 5-seed gate: stride 3 (outlier seeds 0.108-0.114), refine 6 (no
    gain), usable_range 4 (diverges), refine 4 (0.0872 on one seed).
    """
    import math

    from ..ops import m3rsm as m3rsmlib

    step = 1 << levels
    reach = math.ceil((usable_range + hole_width / 2) / map_scale)
    need = 2 * (reach + math.ceil(half_xy / map_scale) + step)
    window = min(-(-need // step) * step, map_size)
    return EngineConfig(
        cell_model=cells.TBMCell(quality=quality),
        matcher="m3rsm",
        matcher_cfg=m3rsmlib.M3RSMConfig(
            half_x=half_xy, half_y=half_xy, half_theta=half_theta,
            n_theta=n_theta, levels=levels, beam_width=beam_width,
            window=window,
            scoring=scoring.ScoringConfig(reducer=reducer, stride=stride),
        ),
        beam=raycast.BeamConfig(
            max_range=usable_range, occupancy_estimator="const",
            # the per-beam DDA free fill: the dense polar fill's
            # conservative neighbor-min range erosion leaves an unknown
            # halo around walls seen at grazing angles. Local sigma-bounded
            # matchers never rank hypotheses across that halo; the M3RSM
            # global B&B does, and aliases (see the docstring)
            hole_width=hole_width, wall_blur=True, free_impl="dda",
        ),
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
        use_angle_histogram=use_angle_histogram,
    )
