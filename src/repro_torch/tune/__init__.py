"""repro_torch.tune — kernel-configuration records and the hook plans
consult (the parts of ``repro.tune.config`` and ``context`` the plans
read; the tuner and its on-disk cache arrive with the autotuning slice of
the port)."""
from repro_torch.tune.config import ConfigKey, KernelConfig
from repro_torch.tune.context import TuningContext, plan_config, use_tuning

__all__ = ["ConfigKey", "KernelConfig", "TuningContext", "plan_config",
           "use_tuning"]
