"""The training step (the counterpart of ``repro.train``;
``train_state_specs`` comes with the dry-run)."""
from repro_torch.train.step import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step"]
