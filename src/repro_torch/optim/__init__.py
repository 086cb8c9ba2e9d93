"""AdamW and the learning-rate schedule (the counterpart of
``repro.optim``; ``optimizer_specs`` comes with the dry-run)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]
