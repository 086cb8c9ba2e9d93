"""Persistent per-device tuning cache — tune once per machine.

The counterpart of ``repro.tune.cache``: a versioned JSON file per device,

    ``~/.cache/repro-torch-tune/<device>.json``
    (override: ``REPRO_TUNE_CACHE``)

mapping :meth:`repro_torch.tune.config.ConfigKey.token` strings to the
chosen :class:`~repro_torch.tune.config.KernelConfig` plus its measurement
record, in the reference's JSON schema.  The default directory is not the
reference's ``repro-tune``: on a machine that runs both packages they
would otherwise share ``cpu.json``, and a tile the port tuned (transforms
per CUDA block) means something else than the reference's (a TPU batch
tile).  ``<device>`` is the sanitised ``torch.cuda.get_device_name()``,
e.g. ``NVIDIA-H100-80GB-HBM3``.

Loads are forgiving by design: a missing, corrupted, or version-mismatched
file yields an *empty* cache (heuristic fallback) — a stale artefact must
never crash a serving process.  Writes are atomic (tmp + rename) so a
crashed tuner can't leave a half-written file behind.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any

import torch

from repro_torch.tune.config import ConfigKey, KernelConfig

#: Bump when the on-disk schema changes; older files fall back to empty.
CACHE_VERSION = 1

#: Environment override for the cache file path (tests, CI, containers).
CACHE_ENV = "REPRO_TUNE_CACHE"

#: Directory under ``~/.cache`` of the port's per-device cache files.
CACHE_DIR = "repro-torch-tune"


def default_device_name() -> str:
    """A filesystem-safe name of the current CUDA device (``cpu`` when no
    GPU is present)."""
    kind = (torch.cuda.get_device_name(torch.cuda.current_device())
            if torch.cuda.is_available() else "cpu")
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", str(kind)).strip("-") or "cpu"


def cache_path(device: str | None = None) -> str:
    """Resolve the on-disk cache location for ``device``."""
    override = os.environ.get(CACHE_ENV, "")
    if override:
        return override
    base = os.path.join(os.path.expanduser("~"), ".cache", CACHE_DIR)
    return os.path.join(base, f"{device or default_device_name()}.json")


@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """One persisted tuning outcome: the choice plus its evidence."""

    config: KernelConfig
    heuristic: KernelConfig = KernelConfig()
    objective: str = "time"
    score: float = 0.0              # chosen config's objective score
    heuristic_score: float = 0.0    # heuristic config's objective score
    measured_s: float = 0.0         # chosen config's seconds/call
    heuristic_s: float = 0.0        # heuristic config's seconds/call
    candidates: int = 0             # generated configs
    measured: int = 0               # survivors actually timed

    @property
    def speedup_vs_heuristic(self) -> float:
        """Measured heuristic time over chosen time (>= 1.0 by contract)."""
        if self.measured_s <= 0.0:
            return 1.0
        return self.heuristic_s / self.measured_s

    def to_dict(self) -> dict[str, Any]:
        return {
            "config": self.config.to_dict(),
            "heuristic": self.heuristic.to_dict(),
            "objective": self.objective,
            "score": self.score,
            "heuristic_score": self.heuristic_score,
            "measured_s": self.measured_s,
            "heuristic_s": self.heuristic_s,
            "candidates": self.candidates,
            "measured": self.measured,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TuneRecord":
        return cls(
            config=KernelConfig.from_dict(d["config"]),
            heuristic=KernelConfig.from_dict(d.get("heuristic") or {}),
            objective=str(d.get("objective", "time")),
            score=float(d.get("score", 0.0)),
            heuristic_score=float(d.get("heuristic_score", 0.0)),
            measured_s=float(d.get("measured_s", 0.0)),
            heuristic_s=float(d.get("heuristic_s", 0.0)),
            candidates=int(d.get("candidates", 0)),
            measured=int(d.get("measured", 0)),
        )


class TuningCache:
    """In-memory view of one device's persisted tuning results."""

    def __init__(self, device: str | None = None,
                 entries: dict[str, TuneRecord] | None = None):
        self.device = device or default_device_name()
        self._entries: dict[str, TuneRecord] = dict(entries or {})
        self.lookups = 0            # test hook: underlying consults

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: ConfigKey) -> bool:
        return key.token() in self._entries

    def get(self, key: ConfigKey) -> TuneRecord | None:
        self.lookups += 1
        return self._entries.get(key.token())

    def put(self, key: ConfigKey, record: TuneRecord) -> None:
        self._entries[key.token()] = record

    def keys(self) -> list[ConfigKey]:
        return [ConfigKey.from_token(t) for t in self._entries]

    def records(self) -> dict[str, TuneRecord]:
        return dict(self._entries)

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, device: str | None = None,
             path: str | None = None) -> "TuningCache":
        """Load the device's cache; ANY failure yields an empty cache.

        Corrupted JSON, a schema-version mismatch, or records that no
        longer parse all degrade to "never tuned" — callers fall back to
        the heuristics and may re-tune, they never crash.
        """
        device = device or default_device_name()
        path = path or cache_path(device)
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
                return cls(device)
            entries = {
                token: TuneRecord.from_dict(rec)
                for token, rec in raw.get("entries", {}).items()
            }
            return cls(device, entries)
        except (OSError, ValueError, KeyError, TypeError):
            return cls(device)

    def save(self, path: str | None = None) -> str:
        """Atomically persist the cache; returns the path written."""
        path = path or cache_path(self.device)
        payload = {
            "version": CACHE_VERSION,
            "device": self.device,
            "entries": {t: r.to_dict() for t, r in self._entries.items()},
        }
        folder = os.path.dirname(os.path.abspath(path))
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, prefix=".repro-tune-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path
