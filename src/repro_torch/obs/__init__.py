"""repro_torch.obs — the port's observability plane (the counterpart of
``repro.obs``).

* :mod:`repro_torch.obs.trace` — deterministic nested-span tracing on an
  injectable clock (``time.time`` by default, the clock ``torch.profiler``
  stamps its host events with), with a per-device flight recorder
  snapshotted by :func:`notify_fault`, and Chrome-trace / JSONL / blake2b
  exporters.  The program's spans go through ``trace.span``, which
  records inside ``with tracer.active():`` and, into a session per
  profiler start (``trace.profiler_spans``), while a ``torch.profiler``
  records; otherwise it is one shared no-op.  A span on a CUDA tensor
  times its device with CUDA events.
* :mod:`repro_torch.obs.metrics` — a counters/gauges/fixed-bucket-histogram
  registry with one Prometheus-style text rendering, plus the guarded
  percentile helper.
* :mod:`repro_torch.obs.ledger` — the kernel launch ledger: every CUDA
  kernel wrapper records its launches (name, grid, tile, bytes moved).
* :mod:`repro_torch.obs.drift` — EWMA model-vs-measured drift detection
  per (kind, shape, clock).
* :mod:`repro_torch.obs.log` — structured key=value logging to stderr.
"""
from repro_torch.obs.drift import DriftDetector, DriftState
from repro_torch.obs.ledger import (LaunchLedger, LaunchRecord,
                                    launches_digest, record_launch)
from repro_torch.obs.log import StructuredLogger, get_logger
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter,
                                     Gauge, Histogram, LatencySummary,
                                     MetricsRegistry, latency_summary)
from repro_torch.obs.trace import (FlightRecorder, FlightSnapshot, Span,
                                   Tracer, digest, notify_fault,
                                   to_chrome_trace, to_jsonl)

__all__ = [
    "DriftDetector", "DriftState",
    "LaunchLedger", "LaunchRecord", "launches_digest", "record_launch",
    "StructuredLogger", "get_logger",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LatencySummary", "latency_summary", "DEFAULT_LATENCY_BUCKETS",
    "FlightRecorder", "FlightSnapshot", "Span", "Tracer",
    "digest", "notify_fault", "to_chrome_trace", "to_jsonl",
]
