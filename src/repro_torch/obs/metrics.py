"""Latency summaries (the part of ``repro.obs.metrics`` the serving layer
reads; the metrics registry arrives with the observability plane)."""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    """Percentile summary of a latency sample (seconds)."""

    n: int
    mean: float
    p50: float
    p99: float


def latency_summary(values: Iterable[float], *,
                    on_empty: float = 0.0) -> LatencySummary:
    """Guarded p50/p99/mean over ``values``.

    With no observations there is no latency evidence, so every field is
    ``on_empty`` (default 0.0) rather than NaN, which keeps report
    arithmetic and JSON serialisation safe.
    """
    arr = np.asarray([float(v) for v in values], dtype=float)
    if arr.size == 0:
        return LatencySummary(n=0, mean=on_empty, p50=on_empty,
                              p99=on_empty)
    return LatencySummary(n=int(arr.size), mean=float(arr.mean()),
                          p50=float(np.percentile(arr, 50)),
                          p99=float(np.percentile(arr, 99)))
