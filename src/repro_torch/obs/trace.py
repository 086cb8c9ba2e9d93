"""Deterministic tracing: nested spans, flight recorder, exporters.

The counterpart of ``repro.obs.trace``.  The :class:`Tracer` follows the
injectable-clock idiom (``tune.timing.time_fn``'s ``timer=``): span
timestamps come from whatever callable the caller provides, so a trace
driven by a fake timer is bit-reproducible, and its JSONL, digest and
Chrome trace are the reference's byte for byte.  The default clock is
``time.time``, ``CLOCK_REALTIME`` in seconds: the clock ``torch.profiler``
(kineto) stamps its host events with, so spans lie on the profiler's
timeline with no conversion.

Spans nest via a context-manager stack and *inherit* their parent's
attributes (``kind``/``shape``/``rung``/``clock_mhz`` set on a batch
span flow down to its children unless overridden).  Completed spans also
feed a bounded per-device :class:`FlightRecorder` ring; :func:`notify_fault`
makes every live tracer snapshot its rings (plus the spans still open at
the moment of failure) for postmortems — the crash-dump analogue of an
aircraft flight recorder.  The reference's fault errors call it when they
are constructed; the port's fault types come with ``runtime.faults``.

The program's own spans (the FFT plan's stages, the kernel wrappers'
launches) go through the module-level :func:`span`.  It records into a
tracer in two cases, and is otherwise one shared no-op:

* inside ``with tracer.active():`` (an operator's or a test's tracer);
* while a ``torch.profiler`` records: each profiler start opens a new
  process-wide session tracer, replacing the one before, which
  :func:`profiler_spans` returns.  A session keeps its last
  :data:`SESSION_SPANS` spans.  The spans never enter the profiler's own
  event stream.

A tracer keeps one stack of open spans, so its spans are opened by one
thread at a time, as the port's plans are.

A span given a tensor (``span(name, x, ...)``) notes its device; on a
CUDA device it records a pair of timing events on the current stream,
and :attr:`Span.device_s` is their elapsed time once the caller has
synchronised (the host duration on any other device).  A tree of spans
times the device once in :data:`DEVICE_PERIOD_S` for each kind of root
span, since each timing event costs the device time.  While a tracer
records, each plan or table built again (:func:`count_build`) adds to
the tracer's ``builds``.

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

import torch

__all__ = ["Span", "FlightSnapshot", "FlightRecorder", "Tracer",
           "notify_fault", "to_chrome_trace", "to_jsonl", "digest",
           "span", "tracing", "count_build", "profiler_spans",
           "SESSION_SPANS", "DEVICE_PERIOD_S"]

#: Spans a profiler session keeps; older ones are dropped and counted.
SESSION_SPANS = 2**16
#: A root span times its tree on the device at most once in this many
#: seconds for each (name, kind, n); the other trees time the host alone.
#: A timing event costs the device about 3 us between two kernels (an
#: H100 under the profiler), which every batch would otherwise add to the
#: traced runs' idle share.
DEVICE_PERIOD_S = 0.5


@dataclasses.dataclass
class Span:
    """One timed region on the tracer's clock (the exporters leave its
    device time out)."""

    name: str
    t_start: float
    duration: float = 0.0
    depth: int = 0                      # nesting depth at open time
    parent: str | None = None           # enclosing span's name
    attrs: dict = dataclasses.field(default_factory=dict)
    # (device, start, end) CUDA events until read, then the seconds.
    _events: list | None = dataclasses.field(default=None, repr=False,
                                             compare=False)
    _device_s: float | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def device_s(self) -> float | None:
        """Seconds the span took on its device: on a CUDA device the
        elapsed time of its events, read once the caller has synchronised
        (None where its tree was not timed, :data:`DEVICE_PERIOD_S`);
        elsewhere the host duration (CPU ops run synchronously)."""
        if self._events is not None:
            device, start, end = self._events
            self._device_s = start.elapsed_time(end) / 1e3
            self._events = None
            _EVENT_POOL[device] += (start, end)
        if self._device_s is not None:
            return self._device_s
        if str(self.attrs.get("device", "")).startswith("cuda"):
            return None
        return self.duration

    def to_dict(self) -> dict:
        return {"name": self.name, "t_start": self.t_start,
                "duration": self.duration, "depth": self.depth,
                "parent": self.parent,
                "attrs": {k: (list(v) if isinstance(v, tuple) else v)
                          for k, v in sorted(self.attrs.items())}}


#: Timing events free for reuse, by device (creating one is not free).
_EVENT_POOL: dict[torch.device, list] = collections.defaultdict(list)


def _start_events(device: str) -> list:
    """A pair of timing events on ``device``, the first recorded on its
    current stream."""
    dev = torch.device(device)
    pool = _EVENT_POOL[dev]
    while len(pool) < 2:
        pool.append(torch.cuda.Event(enable_timing=True))
    start, end = pool.pop(), pool.pop()
    start.record(torch.cuda.current_stream(dev))
    return [dev, start, end]


def _end_events(events: list) -> None:
    """Record the second event of a :func:`_start_events` pair."""
    dev, _, end = events
    end.record(torch.cuda.current_stream(dev))


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
    """Nested-span tracer on an injectable clock (``time.time``, the
    profiler's, by default).

    :attr:`builds` counts the plans and tables built while the tracer was
    in effect (:func:`count_build`)."""

    def __init__(self, timer=time.time, *, recorder_capacity: int = 64):
        self.timer = timer
        self.spans: list[Span] = []     # completed, in completion order
        self.builds: dict[str, int] = {}
        self._stack: list[Span] = []
        self._timed: dict = {}      # (name, kind, n) -> last timed root
        self._time_tree = False
        self.flight = FlightRecorder(capacity=recorder_capacity)
        _TRACERS.add(self)

    @contextlib.contextmanager
    def span(self, name: str, on=None, **attrs):
        """Open a span; children inherit attrs (own keys win).

        ``on``, a tensor, sets the ``device`` attribute to its device; a
        span whose ``device`` is a CUDA device, its own or inherited,
        records timing events on that device's current stream at open
        and at close (:attr:`Span.device_s`) where its tree is timed."""
        parent = self._stack[-1] if self._stack else None
        merged = dict(parent.attrs) if parent is not None else {}
        device = getattr(on, "device", None)
        if device is not None:
            merged["device"] = str(device)
        merged.update(attrs)
        s = Span(name=name, t_start=self.timer(), depth=len(self._stack),
                 parent=parent.name if parent is not None else None,
                 attrs=merged)
        if parent is None:
            key = (name, merged.get("kind"), merged.get("n"))
            last = self._timed.get(key)
            self._time_tree = (last is None
                               or s.t_start - last >= DEVICE_PERIOD_S)
            if self._time_tree:
                self._timed[key] = s.t_start
        device = merged.get("device")
        if (self._time_tree and isinstance(device, str)
                and device.startswith("cuda")):
            s._events = _start_events(device)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            if s._events is not None:
                _end_events(s._events)
            s.duration = self.timer() - s.t_start
            self._keep(s)
            self.flight.push(s)

    def _keep(self, s: Span) -> None:
        self.spans.append(s)

    @contextlib.contextmanager
    def active(self):
        """Record the module-level :func:`span` and :func:`count_build`
        into this tracer inside the block."""
        _ACTIVE.append(self)
        _refresh()
        try:
            yield self
        finally:
            _ACTIVE.pop()
            _refresh()


class _Session(Tracer):
    """A profiler session's tracer: its last :data:`SESSION_SPANS` spans,
    the older ones counted in :attr:`dropped`."""

    def __init__(self):
        super().__init__()
        self.spans = collections.deque(maxlen=SESSION_SPANS)
        self.dropped = 0

    def _keep(self, s: Span) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(s)


# ---------------------------------------------------------------------------
# the program's spans: the active tracer or the profiler's session
# ---------------------------------------------------------------------------

_ACTIVE: list[Tracer] = []          # Tracer.active() blocks, innermost last
_SESSION: _Session | None = None    # the last profiler session's tracer
_PROFILING = False                  # a torch.profiler records
_CURRENT: Tracer | None = None      # where span() records, or None


class _NoSpan:
    """What :func:`span` returns while nothing records: one shared no-op."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


def span(name: str, on=None, **attrs):
    """A span of the program, recorded into the tracer in effect: the
    innermost ``Tracer.active()`` block's, else the profiler session's
    while a ``torch.profiler`` records; else one shared no-op.  ``on``
    and ``attrs`` as :meth:`Tracer.span`."""
    tracer = _CURRENT
    if tracer is None:
        return _NO_SPAN
    return tracer.span(name, on, **attrs)


def tracing() -> bool:
    """Whether :func:`span` records (for attributes that cost to compute)."""
    return _CURRENT is not None


def count_build(what: str) -> None:
    """Count one build of ``what`` (a cache miss of a plan or a table)
    in the tracer in effect."""
    tracer = _CURRENT
    if tracer is not None:
        tracer.builds[what] = tracer.builds.get(what, 0) + 1


def profiler_spans() -> Tracer | None:
    """The tracer of the last ``torch.profiler`` session (None before the
    first): its spans, ``builds`` and ``dropped``."""
    return _SESSION


def _refresh() -> None:
    global _CURRENT
    _CURRENT = _ACTIVE[-1] if _ACTIVE else (_SESSION if _PROFILING else None)


def _on_profiler(start: bool) -> None:
    global _SESSION, _PROFILING
    if start:
        _SESSION = _Session()
    _PROFILING = start
    _refresh()


def _watch_profiler() -> None:
    """Follow every profiler's start and stop: torch calls
    ``torch.autograd.profiler._run_on_profiler_start`` and ``_stop`` (which
    set its ``_is_profiler_enabled``) from each profiler it starts or
    stops, and each is wrapped here once a process."""
    from torch.autograd import profiler
    for name, start in (("_run_on_profiler_start", True),
                        ("_run_on_profiler_stop", False)):
        run = getattr(profiler, name, None)
        if run is None or getattr(run, "_repro_spans", False):
            continue

        def hooked(run=run, start=start):
            run()
            _on_profiler(start)
        hooked._repro_spans = True
        setattr(profiler, name, hooked)


_watch_profiler()


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
