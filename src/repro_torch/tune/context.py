"""The TuningContext hook — how plans find their tuned configuration.

The counterpart of ``repro.tune.context``.  ``repro_torch.fft.plan`` calls
:func:`plan_config` while *building* a plan:

  1. no active context  ->  ``None`` — the heuristic plan.
  2. active context     ->  the tuned
     :class:`~repro_torch.tune.config.KernelConfig` for
     ``(device, shape, kind, dtype)``, or ``None`` when it holds no entry.

A context is an in-memory map from :class:`~repro_torch.tune.config.ConfigKey`
to config; the tuner that fills it, and the on-disk cache it is loaded
from, arrive with the autotuner slice of the port.  A context consults its
map **exactly once** per distinct key and memoises the answer
(``consults`` is the counter the tests pin).

This module imports nothing from ``repro_torch.fft`` so the planners can
import it without a cycle.
"""
from __future__ import annotations

import contextlib
from typing import Mapping

from repro_torch.tune.config import ConfigKey, KernelConfig


class TuningContext:
    """Memoised view of one device's tuned configs for plan construction."""

    def __init__(self, configs: Mapping[ConfigKey, KernelConfig],
                 device: str, dtype: str = "fp32"):
        self.configs = dict(configs)
        self.device = device
        self.dtype = dtype
        self.consults = 0           # map reads (memo misses)
        self._memo: dict[ConfigKey, KernelConfig | None] = {}

    def config_for(self, shape: tuple[int, ...], kind: str = "c2c",
                   dtype: str | None = None) -> KernelConfig | None:
        """The tuned config for a key, or None (heuristic) when untuned."""
        key = ConfigKey(device=self.device, shape=tuple(shape), kind=kind,
                        dtype=dtype or self.dtype)
        if key not in self._memo:
            self.consults += 1
            cfg = self.configs.get(key)
            self._memo[key] = None if cfg is None or cfg.is_heuristic else cfg
        return self._memo[key]


_ACTIVE: TuningContext | None = None


@contextlib.contextmanager
def use_tuning(ctx: TuningContext | None):
    """Install ``ctx`` process-wide inside the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def plan_config(shape: tuple[int, ...], kind: str = "c2c",
                dtype: str = "fp32") -> KernelConfig | None:
    """What the planners call: the active tuned config, or None ("run the
    heuristics") with no context or no entry."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.config_for(tuple(shape), kind, dtype)
