"""Seeded request arrival-time distributions for serving benchmarks.

The counterpart of ``repro.data.arrivals`` (numpy; the same arrays for a
seed).

Real edge telescopes do not deliver work on a fixed grid: channelised
voltage dumps and candidate follow-ups arrive as a point process.  The
crash-and-recover harness drives the service from one of two classic
processes, both fully seeded so any two runs of the same schedule see
bit-identical arrival times:

  poisson   exponential inter-arrival gaps — the memoryless baseline
            (counts per drain window are Poisson-distributed, so wave
            sizes genuinely vary).
  gamma     Gamma(k)-distributed gaps at the same mean rate.  ``k < 1``
            is burstier than Poisson (heavy clumps and long silences,
            the shape transient RFI storms have), ``k > 1`` smoother
            (closer to the pipeline's own periodic dump cadence).

Times are *simulated* seconds: they define which requests share a drain
wave (the service drains once per ``period_s`` of arrival time), not
when wall-clock work happens.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["arrival_times", "wave_slices"]


def arrival_times(n: int, *, seed: int, process: str = "poisson",
                  rate_hz: float = 1000.0,
                  gamma_shape: float = 0.5) -> np.ndarray:
    """``n`` cumulative arrival times [s] of a seeded point process.

    ``rate_hz`` is the mean arrival rate for both processes (the gamma
    scale is ``1 / (gamma_shape * rate_hz)`` so changing the shape
    changes burstiness, never the load).
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if rate_hz <= 0.0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    if process == "poisson":
        gaps = rng.exponential(scale=1.0 / rate_hz, size=n)
    elif process == "gamma":
        if gamma_shape <= 0.0:
            raise ValueError(
                f"gamma_shape must be > 0, got {gamma_shape}")
        gaps = rng.gamma(shape=gamma_shape,
                         scale=1.0 / (gamma_shape * rate_hz), size=n)
    else:
        raise ValueError(
            f"unknown arrival process {process!r}; "
            f"have 'poisson' or 'gamma'")
    return np.cumsum(gaps)


def wave_slices(times: np.ndarray,
                period_s: float) -> Iterator[tuple[int, int]]:
    """Split arrival times into drain waves of ``period_s`` simulated
    seconds; yields half-open index ranges ``(start, stop)``.

    Empty periods are skipped (the service has nothing to drain), so
    every yielded wave is non-empty and the ranges tile ``[0, len)``.
    """
    if period_s <= 0.0:
        raise ValueError(f"period_s must be > 0, got {period_s}")
    n = len(times)
    start = 0
    while start < n:
        boundary = (np.floor(times[start] / period_s) + 1.0) * period_s
        stop = int(np.searchsorted(times, boundary, side="left"))
        stop = max(stop, start + 1)         # numerical-edge safety
        yield start, stop
        start = stop
