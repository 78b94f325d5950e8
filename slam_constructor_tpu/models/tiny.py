"""tinySLAM preset (Steux & El Hamzaoui 2010).

Parity: the reference's ``src/slams/tiny/`` node (SURVEY.md §2.6
[unverified]): single hypothesis, Monte-Carlo scan matcher with sigma
annealing, plain occupancy grid, Bayes cell models (``BaseTinyCell`` /
``AvgTinyCell``), wall-blur ("hole width") scan adder.
"""

from __future__ import annotations

from ..ops import cells, matchers, raycast, scoring
from .engine import Engine, EngineConfig


def tiny_config(
    cell: str = "bayes_avg",
    quality: float = 0.5,
    map_size: int = 256,
    map_scale: float = 0.1,
    hole_width: float = 0.3,
    mc_batch: int = 64,
    mc_rounds: int = 12,
    sigma_xy: float = 0.08,
    sigma_theta: float = 0.05,
    scoring_cfg: scoring.ScoringConfig | None = None,
) -> EngineConfig:
    if scoring_cfg is None:
        scoring_cfg = scoring.ScoringConfig(reducer="overlap", window=1, stride=1)
    if cell == "bayes_base":
        model = cells.BayesBaseCell(quality=quality)
    else:
        model = cells.BayesAvgCell()
    return EngineConfig(
        cell_model=model,
        matcher="monte_carlo",
        matcher_cfg=matchers.MonteCarloConfig(
            sigma_xy=sigma_xy,
            sigma_theta=sigma_theta,
            batch=mc_batch,
            rounds=mc_rounds,
            scoring=scoring_cfg,
        ),
        beam=raycast.BeamConfig(
            occupancy_estimator="const", hole_width=hole_width, wall_blur=True,
            free_impl="dda",
        ),
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
    )


def make_engine(**kwargs) -> Engine:
    return Engine(tiny_config(**kwargs))


def fast_config(
    map_size: int = 256,
    map_scale: float = 0.1,
    usable_range: float = 8.0,
    stride: int = 1,
    hole_width: float = 0.3,
    **kwargs,
) -> EngineConfig:
    """Windowed tiny operating point (the gmapping.fast_config discipline
    brought to the single-hypothesis engine): usable-range-capped beams +
    a prior-centered match window covering exactly that reach + beam
    stride in the matcher. Matching's sampling operands shrink by
    (map/window)^2.

    Defaults (3-seed CPU 2-lap ATE vs the full-map default's 0.070):
    range 8 / stride 1 = 0.071-0.108; range 6 or stride 2 at 120-beam
    scans diverge on one seed (0.54-0.67) — the single hypothesis has no
    particle diversity to absorb a lossy matcher, so the fast knobs stay
    conservative here. At 360-beam scans stride=2 is worth opting into
    (the RBPF's measured tradeoff, gmapping.fast_config)."""
    import dataclasses

    cells_reach = int(-(-(usable_range + hole_width) // map_scale)) + 4
    win = min(2 * ((cells_reach + 15) // 16 * 16), map_size)
    cfg = tiny_config(
        map_size=map_size, map_scale=map_scale, hole_width=hole_width,
        scoring_cfg=scoring.ScoringConfig(
            reducer="overlap", window=1, stride=stride),
        **kwargs,
    )
    return dataclasses.replace(
        cfg,
        match_window=win,
        beam=raycast.BeamConfig(
            max_range=usable_range, occupancy_estimator="const",
            hole_width=hole_width, wall_blur=True, free_impl="dda",
        ),
    )
