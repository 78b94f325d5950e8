"""Profiling + speed-of-light reporting (SURVEY.md §5; BASELINE requires
per-kernel roofline reporting).

- ``device_specs()``: peak FLOP/s / HBM bandwidth of the attached device,
  keyed on ``device_kind``; an unknown device is an error.
- ``sol_report(...)``: roofline model — measured time vs. the max(compute,
  memory) bound for declared flops/bytes.
- ``timed(...)``: median wall time per call, each ending in
  ``jax.block_until_ready``.
- ``trace(...)``: jax.profiler wrapper for Perfetto/XProf dumps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceSpecs:
    name: str
    peak_flops_bf16: float  # FLOP/s, dense, tensor cores
    peak_flops_f32: float  # FLOP/s, without the tensor cores
    hbm_bandwidth: float  # B/s


#: Published peaks (NVIDIA H100 data sheet, dense rates without sparsity,
#: at the full power limit), keyed on a substring of ``device_kind``.
#: The PCIe part is matched first: its kind also contains "H100".
_KNOWN = (
    ("h100 pcie", DeviceSpecs("h100_pcie", 756e12, 51e12, 2.0e12)),
    ("h100", DeviceSpecs("h100_sxm", 989e12, 67e12, 3.35e12)),
)


def device_specs(kind: str | None = None) -> DeviceSpecs:
    """Peaks of the device whose ``device_kind`` is ``kind`` (default: the
    first attached device). Raises ``KeyError`` for a device with no row:
    a roofline share against a guessed peak would be meaningless."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    low = kind.lower()
    for key, spec in _KNOWN:
        if key in low:
            return spec
    raise KeyError(f"no published peaks for device kind {kind!r}")


def device_info() -> dict:
    """The attached devices as JAX reports them."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def timed(f, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median-of-runs wall time per call (seconds)."""
    for _ in range(warmup):
        out = f(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def sol_report(
    name: str, measured_s: float, flops: float = 0.0, bytes_accessed: float = 0.0,
    dtype: str = "f32", spec: DeviceSpecs | None = None,
) -> dict:
    """Roofline: achieved fraction of the compute/memory bound against
    ``spec`` (default: the attached device's published peaks)."""
    spec = spec or device_specs()
    peak = spec.peak_flops_bf16 if dtype == "bf16" else spec.peak_flops_f32
    t_compute = flops / peak if flops else 0.0
    t_memory = bytes_accessed / spec.hbm_bandwidth if bytes_accessed else 0.0
    t_sol = max(t_compute, t_memory, 1e-12)
    return {
        "kernel": name,
        "device": spec.name,
        "measured_ms": measured_s * 1e3,
        "sol_ms": t_sol * 1e3,
        "sol_fraction": t_sol / measured_s if measured_s > 0 else 0.0,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def trace(logdir: str = os.path.join(_REPO, "traces")):
    """Capture a Perfetto/XProf trace around a code block (default
    directory: ``traces/`` in the checkout, git-ignored)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Lightweight per-step host timer with summary stats (the engine's
    matcher-observer hook equivalent for wall time)."""

    def __init__(self):
        self.samples: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = np.asarray(self.samples)
        return {
            "steps": len(s),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
            "steps_per_sec": float(1.0 / s.mean()),
        }
