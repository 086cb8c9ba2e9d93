"""repro_torch.tune — energy-aware kernel-configuration autotuning.

The counterpart of ``repro.tune``.  The paper tunes the *clock* per
(device, length, precision) by sweep and measurement; this package tunes
the *kernel configuration* per ``(device, shape, kind, dtype)`` the same
way: generate candidates, prune them with the analytic cost model,
measure the survivors on the card (CUDA events), score under a time or
energy objective, and persist the choice to a per-device on-disk cache so
tuning happens once per machine.

Entry points:

  tune_length / tune_segment    tune one key (replay from cache if tuned)
  common_config                 the Sec.-4 single-best-config result
  install_common_default        install it for every untuned shape
  TuningContext / use_tuning    what the planners consult
  TuningCache                   the persistent artefact
  time_fn                       the shared timing helper
"""
from repro_torch.tune.cache import (CACHE_ENV, CACHE_VERSION, TuneRecord,
                                    TuningCache, cache_path,
                                    default_device_name)
from repro_torch.tune.config import (HEURISTIC, ConfigKey, KernelConfig,
                                     SOURCE_COMMON, SOURCE_HEURISTIC,
                                     SOURCE_TUNED)
from repro_torch.tune.context import (DISABLE_ENV, TuningContext,
                                      get_tuning_context, plan_config,
                                      set_tuning_context, tuning_enabled,
                                      use_tuning)
from repro_torch.tune.timing import time_fn
from repro_torch.tune.tuner import (TuneResult, common_config,
                                    generate_candidates,
                                    install_common_default,
                                    prune_candidates, tune_length,
                                    tune_segment)

__all__ = [
    "CACHE_ENV", "CACHE_VERSION", "DISABLE_ENV", "HEURISTIC",
    "ConfigKey", "KernelConfig", "SOURCE_COMMON", "SOURCE_HEURISTIC",
    "SOURCE_TUNED", "TuneRecord", "TuneResult", "TuningCache",
    "TuningContext", "cache_path", "common_config", "default_device_name",
    "generate_candidates", "get_tuning_context", "install_common_default",
    "plan_config", "prune_candidates", "set_tuning_context", "time_fn",
    "tune_length", "tune_segment", "tuning_enabled", "use_tuning",
]
