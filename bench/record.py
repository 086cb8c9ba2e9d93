"""What one run records: its units of work, the window, the checks.

The generators fill a :class:`Window`; the metric readers (``metrics/``)
read a :class:`Run`.
"""
from __future__ import annotations

import dataclasses
import time

from bench.yardstick.trace import Profiled, Trace

#: The traced sub-window opens halfway through the window and lasts this
#: long [s] of host time after the profiler has started; the window's
#: first half, before the profiler starts, is what the power plane's
#: per-layer metrics read.
TRACE_S = 2.0


@dataclasses.dataclass
class Unit:
    """One unit of work of the window, such as a batch of transforms.

    ``t_start``/``t_end`` are host-clock seconds; a unit dispatched
    ahead has no end of its own (None)."""

    kind: str
    n: int
    rows: int
    points: int                 # transform points completed
    in_bytes: int               # input consumed
    t_start: float
    t_end: float | None = None


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    units: list[Unit]
    kept: dict                  # what the generator kept for the check
    trace: Trace | None = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Check:
    """A number compared, with its limit: it passes at or below it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""

    setup_s: float
    window: Window
    energy: dict | None         # the NVML meter's reading of the window
    cfg: dict
    traffic: dict


class TraceWindow:
    """When a generator's loop opens and closes the profiled sub-window.

    The loop calls :meth:`at` at each boundary between units with the
    host time since the window opened and the units run so far, and
    does not close the window before :attr:`done`: the profiler takes
    seconds to start, and the sub-window is timed from its start."""

    def __init__(self, device, seconds: float):
        self.profiled = Profiled(device)
        self.seconds = seconds
        self.first: int | None = None
        self.host_open = 0.0        # host clock when the profiler starts
        self.opened = 0.0           # and when it has started
        self.trace: Trace | None = None

    @property
    def done(self) -> bool:
        return self.trace is not None

    def at(self, elapsed: float, units: list[Unit]) -> None:
        if self.done:
            return
        if self.first is None:
            if elapsed >= self.seconds / 2:
                self.host_open = time.perf_counter()
                self.profiled.begin()
                self.first, self.opened = len(units), time.perf_counter()
            return
        if (len(units) > self.first
                and time.perf_counter() - self.opened >= TRACE_S):
            self.trace = self.profiled.end(units[self.first:])
