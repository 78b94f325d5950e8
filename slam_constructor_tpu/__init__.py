"""slam_constructor_tpu — an accelerator-native 2D laser SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
``OSLL/slam_constructor`` (C++/ROS): occupancy-grid mapping with pluggable
grid-cell belief models (Bayesian / Transferable-Belief-Model), Monte-Carlo /
hill-climbing / brute-force / M3RSM scan matchers, GMapping-style
particle-filter hypothesis tracking, and keyframe pose-graph optimization with
loop closure — all expressed as pure functions over array state, jitted and
sharded over device meshes. It runs on NVIDIA GPUs (and on the CPU for tests).

Layer map (mirrors SURVEY.md §1, re-architected array-first):

- ``ops``      — L0–L2 kernels: SE(2) algebra, grid maps, cell models,
                 ray casting / scan insertion, scan-likelihood scoring,
                 scan matchers, M3RSM, resampling.
- ``models``   — L3 algorithms: tinySLAM, vinySLAM, GMapping RBPF,
                 pose-graph/loop-closure pipeline, plus the generic engine.
- ``parallel`` — multi-device/multi-host sharding: particle sharding, map-block
                 halo exchange, distributed Gauss-Newton reductions.
- ``utils``    — config presets, synthetic data generation, dataset IO,
                 ATE/RPE evaluation, checkpointing, metrics, profiling.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level convenience API (avoids importing jax at package
    import time): ``slam_constructor_tpu.tiny_engine()`` etc."""
    makers = {
        "tiny_engine": ("models.tiny", "make_engine"),
        "viny_engine": ("models.viny", "make_engine"),
        "gmapping_engine": ("models.gmapping", "GMappingEngine"),
        "full_engine": ("models.full", "FullSlamEngine"),
        "preset": ("utils.config", "preset"),
        "read_carmen": ("utils.dataset", "read_carmen"),
        "ate": ("utils.evaluate", "ate"),
    }
    if name in makers:
        import importlib

        mod, attr = makers[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(name)
