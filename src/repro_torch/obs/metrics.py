"""A deterministic metrics registry: counters, gauges, fixed histograms.

The counterpart of ``repro.obs.metrics``: one registry renders the
service's statistics once in the Prometheus text format, byte for byte
the reference's rendering.

Determinism rules (two runs that observe the same values render the same
text):

* counters are integers and only ever increment;
* histograms have *fixed* bucket bounds chosen at creation and count
  integer observations per bucket — no wall-clock reads, no float
  accumulation (there is deliberately no ``_sum`` series: summing
  measured floats is the one place Prometheus conventions and
  bit-reproducibility disagree);
* gauges hold the single float they were last set to.

:func:`latency_summary` is the guarded-percentile helper the serving
layer's report uses.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LatencySummary", "latency_summary",
           "DEFAULT_LATENCY_BUCKETS"]

#: Default latency histogram bounds [s] (the reference's): sub-ms batches
#: up to multi-second drains.
DEFAULT_LATENCY_BUCKETS = (1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0,
                           5.0, 30.0)


def _fmt(v) -> str:
    """Prometheus sample value: integral floats render as integers."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonic integer counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        n = int(n)
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n

    def render(self) -> list[str]:
        return [f"{self.name} {self.value}"]


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Fixed-bound bucket histogram (cumulative render, no float sum)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        if not buckets or list(buckets) != sorted(set(float(b)
                                                      for b in buckets)):
            raise ValueError(
                f"histogram {name} needs strictly increasing bounds, "
                f"got {buckets!r}")
        self.name, self.help = name, help
        self.bounds = tuple(float(b) for b in buckets)
        # counts[i]: observations in (bounds[i-1], bounds[i]];
        # counts[-1] is the +Inf overflow bucket.
        self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def n(self) -> int:
        return sum(self.counts)

    def quantile(self, q: float) -> float:
        """Histogram-derived quantile: the upper bound of the bucket the
        q-th observation falls in (conservative — never understates).
        Empty histograms and overflow-bucket hits return the top bound.
        """
        total = self.n
        if total == 0:
            return 0.0
        target = max(1, int(np.ceil(q * total)))
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += self.counts[i]
            if cum >= target:
                return b
        return self.bounds[-1]

    def render(self) -> list[str]:
        lines, cum = [], 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.n}')
        lines.append(f"{self.name}_count {self.n}")
        return lines


class MetricsRegistry:
    """Named metrics with get-or-create accessors and one text render."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def render(self) -> str:
        """The Prometheus text exposition of every registered metric."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# shared guarded percentile summary
# ---------------------------------------------------------------------------

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

    Empty-input convention (the percentile analogue of
    ``repro_torch.core.energy.guarded_ratio``): with no observations there is
    no latency evidence, so every field is ``on_empty`` (default 0.0 —
    "no latency was incurred") rather than NaN, keeping report
    arithmetic and JSON serialisation safe.
    """
    arr = np.asarray([float(v) for v in values], dtype=float)
    if arr.size == 0:
        return LatencySummary(n=0, mean=on_empty, p50=on_empty,
                              p99=on_empty)
    return LatencySummary(n=int(arr.size), mean=float(arr.mean()),
                          p50=float(np.percentile(arr, 50)),
                          p99=float(np.percentile(arr, 99)))
