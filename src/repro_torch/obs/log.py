"""Structured key=value logging (the counterpart of ``repro.obs.log``).

A deliberately small logger (no stdlib ``logging`` config surface): one
line per event, ``LEVEL component: event key=value ...``, written to
stderr.  The level threshold is resolved *per call* from the
environment:

* ``REPRO_LOG_LEVEL`` (debug/info/warning/error, or ``off``) wins;
* otherwise, under pytest (``PYTEST_CURRENT_TEST`` set) everything is
  silenced — test output stays clean unless a test opts in;
* otherwise the default is ``info``.

Lines are the reference's, character for character.
"""
from __future__ import annotations

import os
import sys
from typing import Any, TextIO

__all__ = ["StructuredLogger", "get_logger", "LEVELS"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _threshold() -> int | None:
    """The active minimum level, or None when fully silenced."""
    env = os.environ.get("REPRO_LOG_LEVEL", "").strip().lower()
    if env:
        if env in ("off", "none", "silent"):
            return None
        return LEVELS.get(env, LEVELS["info"])
    if "PYTEST_CURRENT_TEST" in os.environ:
        return None
    return LEVELS["info"]


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    s = str(v)
    return repr(s) if (" " in s or s == "") else s


class StructuredLogger:
    """level + event + key=value pairs on one stderr line."""

    def __init__(self, component: str, *, stream: TextIO | None = None):
        self.component = component
        self._stream = stream          # None: resolve sys.stderr per call

    def log(self, level: str, event: str, **fields: Any) -> None:
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; have "
                             f"{sorted(LEVELS)}")
        thr = _threshold()
        if thr is None or LEVELS[level] < thr:
            return
        parts = [f"{k}={_fmt_value(v)}" for k, v in fields.items()]
        line = f"{level.upper():<7} {self.component}: {event}"
        if parts:
            line += " " + " ".join(parts)
        print(line, file=self._stream or sys.stderr)

    def debug(self, event: str, **fields: Any) -> None:
        self.log("debug", event, **fields)

    def info(self, event: str, **fields: Any) -> None:
        self.log("info", event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self.log("warning", event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self.log("error", event, **fields)


_LOGGERS: dict[str, StructuredLogger] = {}


def get_logger(component: str) -> StructuredLogger:
    """One cached logger per component name."""
    lg = _LOGGERS.get(component)
    if lg is None:
        lg = _LOGGERS[component] = StructuredLogger(component)
    return lg
