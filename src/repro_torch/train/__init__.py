"""The training step and its state's PartitionSpecs (the counterpart of
``repro.train``)."""
from repro_torch.train.step import (TrainState, make_train_step,
                                    train_state_specs)

__all__ = ["TrainState", "make_train_step", "train_state_specs"]
