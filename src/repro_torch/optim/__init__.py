"""AdamW, its state's PartitionSpecs and the learning-rate schedule (the
counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     optimizer_specs)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "optimizer_specs"]
