"""The TuningContext hook — how plans find their tuned configuration.

The counterpart of ``repro.tune.context``.  ``repro_torch.fft.plan`` /
``plan_nd`` / ``convolve`` call :func:`plan_config` while *building* a
plan.  The resolution order is:

  1. ``REPRO_FFT_DISABLE_TUNING=1``  ->  ``None`` — the heuristic path,
     bit-for-bit (plan builders memoise on the config, so the disabled
     path shares the exact heuristic plan objects).
  2. no active context               ->  ``None`` (same heuristic path).
  3. active context                  ->  the tuned
     :class:`~repro_torch.tune.config.KernelConfig` for
     ``(device, shape, kind, dtype)``, or ``None`` when the cache has no
     entry (the context's common config, when one is installed).

A context consults its underlying :class:`~repro_torch.tune.cache.TuningCache`
**exactly once** per distinct key and memoises the answer — repeated plan
builds and serving-cache rebuilds never re-read the cache (``consults`` is
the counter the routing tests pin).

This module imports nothing from ``repro_torch.fft`` so the planners can
import it without a cycle.
"""
from __future__ import annotations

import contextlib
import os

from repro_torch.tune.cache import TuningCache
from repro_torch.tune.config import ConfigKey, KernelConfig

#: Escape hatch: restores the heuristics everywhere.
DISABLE_ENV = "REPRO_FFT_DISABLE_TUNING"


def tuning_enabled() -> bool:
    return os.environ.get(DISABLE_ENV, "") not in ("1", "true")


class TuningContext:
    """Memoised view of one device's tuning cache for plan construction."""

    def __init__(self, cache: TuningCache | None = None,
                 device: str | None = None, dtype: str = "fp32"):
        self.cache = cache if cache is not None else TuningCache.load(device)
        self.device = device or self.cache.device
        self.dtype = dtype
        self.consults = 0           # underlying cache reads (memo misses)
        #: Optional Sec.-4-style common config served to *untuned* keys
        #: (set by ``repro_torch.tune.tuner.install_common_default``).
        self.common: KernelConfig | None = None
        self._memo: dict[ConfigKey, KernelConfig | None] = {}

    def key_for(self, shape: tuple[int, ...], kind: str = "c2c",
                dtype: str | None = None) -> ConfigKey:
        return ConfigKey(device=self.device, shape=tuple(shape), kind=kind,
                         dtype=dtype or self.dtype)

    def config_for(self, shape: tuple[int, ...], kind: str = "c2c",
                   dtype: str | None = None) -> KernelConfig | None:
        """The tuned config for a key, or None (heuristic) when untuned."""
        key = self.key_for(shape, kind, dtype)
        if key in self._memo:
            return self._memo[key]
        self.consults += 1
        record = self.cache.get(key)
        cfg = None
        if record is not None and not record.config.is_heuristic:
            cfg = record.config
        elif record is None and self.common is not None \
                and not self.common.is_heuristic:
            cfg = self.common           # Sec. 4: one shared setting
        self._memo[key] = cfg
        return cfg

    def invalidate(self) -> None:
        """Drop memoised answers (after re-tuning into the same cache)."""
        self._memo.clear()


_ACTIVE: TuningContext | None = None


def get_tuning_context() -> TuningContext | None:
    return _ACTIVE


def set_tuning_context(ctx: TuningContext | None) -> TuningContext | None:
    """Install ``ctx`` process-wide; returns the previous context."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    return prev


@contextlib.contextmanager
def use_tuning(ctx: TuningContext | None):
    """Scoped installation — tests and the tuner's measurement loop."""
    prev = set_tuning_context(ctx)
    try:
        yield ctx
    finally:
        set_tuning_context(prev)


def plan_config(shape: tuple[int, ...], kind: str = "c2c",
                dtype: str = "fp32") -> KernelConfig | None:
    """What the planners call: the active tuned config or None.

    ``None`` means "run the heuristics" — the disabled path and the
    no-context/no-entry paths all return it, so plan memoisation collapses
    all three onto the single heuristic plan object.
    """
    if not tuning_enabled():
        return None
    ctx = get_tuning_context()
    if ctx is None:
        return None
    return ctx.config_for(tuple(shape), kind, dtype)
