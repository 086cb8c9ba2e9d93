"""Deterministic tracing: nested spans, flight recorder, exporters.

The counterpart of ``repro.obs.trace``.  The :class:`Tracer` follows the
injectable-clock idiom (``tune.timing.time_fn``'s ``timer=``): span
timestamps come from whatever monotonic callable the caller provides, so
a trace driven by a fake timer is bit-reproducible, and its JSONL,
digest and Chrome trace are the reference's byte for byte.

Spans nest via a context-manager stack and *inherit* their parent's
attributes (``kind``/``shape``/``rung``/``clock_mhz`` set on a batch
span flow down to its children unless overridden).  Completed spans also
feed a bounded per-device :class:`FlightRecorder` ring; :func:`notify_fault`
makes every live tracer snapshot its rings (plus the spans still open at
the moment of failure) for postmortems — the crash-dump analogue of an
aircraft flight recorder.  The reference's fault errors call it when they
are constructed; the port's fault types come with ``runtime.faults``.

Exporters: :func:`to_chrome_trace` (load the JSON in ``about:tracing``
/ Perfetto), :func:`to_jsonl` (one span per line, canonical key order)
and :func:`digest` (blake2b of the JSONL).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import time
import weakref
from typing import Any

__all__ = ["Span", "FlightSnapshot", "FlightRecorder", "Tracer",
           "notify_fault", "to_chrome_trace", "to_jsonl", "digest"]


@dataclasses.dataclass
class Span:
    """One timed region on the tracer's clock."""

    name: str
    t_start: float
    duration: float = 0.0
    depth: int = 0                      # nesting depth at open time
    parent: str | None = None           # enclosing span's name
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "t_start": self.t_start,
                "duration": self.duration, "depth": self.depth,
                "parent": self.parent,
                "attrs": {k: (list(v) if isinstance(v, tuple) else v)
                          for k, v in sorted(self.attrs.items())}}


@dataclasses.dataclass(frozen=True)
class FlightSnapshot:
    """The flight-recorder state frozen at the moment of one fault."""

    error_type: str                     # the error's class name
    message: str
    spans: dict                         # device -> last-N completed spans
    open_spans: tuple                   # spans still open when it fired


class FlightRecorder:
    """Bounded per-device ring of the most recent completed spans."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._rings: dict[Any, collections.deque] = {}
        self.snapshots: list[FlightSnapshot] = []

    def push(self, span: Span) -> None:
        dev = span.attrs.get("worker", -1)
        ring = self._rings.get(dev)
        if ring is None:
            ring = self._rings[dev] = collections.deque(
                maxlen=self.capacity)
        ring.append(span)

    def ring(self, device: Any = -1) -> list[Span]:
        return list(self._rings.get(device, ()))

    def snapshot(self, error: BaseException,
                 open_spans: tuple = ()) -> FlightSnapshot:
        snap = FlightSnapshot(
            error_type=type(error).__name__, message=str(error),
            spans={dev: list(ring)
                   for dev, ring in sorted(self._rings.items(),
                                           key=lambda kv: str(kv[0]))},
            open_spans=tuple(open_spans))
        self.snapshots.append(snap)
        return snap


#: Live tracers, notified by :func:`notify_fault`.  A WeakSet so
#: abandoned tracers (and their retained spans) are collectable.
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def notify_fault(error: BaseException) -> None:
    """Snapshot every live tracer's flight recorder for ``error``.

    Meant to be called when a fault error is constructed; a no-op with no
    tracers alive.
    """
    for tracer in list(_TRACERS):
        tracer.flight.snapshot(error, open_spans=tuple(tracer._stack))


class Tracer:
    """Nested-span tracer on an injectable monotonic clock."""

    def __init__(self, timer=time.monotonic, *,
                 recorder_capacity: int = 64):
        self.timer = timer
        self.spans: list[Span] = []         # completed, in completion order
        self._stack: list[Span] = []
        self.flight = FlightRecorder(capacity=recorder_capacity)
        _TRACERS.add(self)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Open a span; children inherit attrs (own keys win)."""
        parent = self._stack[-1] if self._stack else None
        merged = dict(parent.attrs) if parent is not None else {}
        merged.update(attrs)
        s = Span(name=name, t_start=self.timer(), depth=len(self._stack),
                 parent=parent.name if parent is not None else None,
                 attrs=merged)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.duration = self.timer() - s.t_start
            self.spans.append(s)
            self.flight.push(s)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def to_jsonl(spans: list[Span]) -> str:
    """One canonical JSON object per line (sorted keys, no whitespace)."""
    return "\n".join(json.dumps(s.to_dict(), sort_keys=True,
                                separators=(",", ":")) for s in spans)


def digest(spans: list[Span]) -> str:
    """blake2b over the canonical JSONL — identical spans, identical hex."""
    return hashlib.blake2b(to_jsonl(spans).encode(),
                           digest_size=16).hexdigest()


def to_chrome_trace(spans: list[Span]) -> dict:
    """Chrome trace-event JSON (complete "X" events, microsecond times).

    ``tid`` is the span's worker attribute so each device renders as its
    own track in about:tracing / Perfetto.
    """
    events = []
    for s in spans:
        attrs = s.to_dict()["attrs"]
        events.append({
            "name": s.name, "ph": "X", "pid": 0,
            "tid": int(attrs.get("worker", 0) or 0),
            "ts": s.t_start * 1e6, "dur": s.duration * 1e6,
            "args": attrs,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
