"""Training of the port (``repro/train``): the step, not yet the loop."""

from .step import TrainConfig, TrainState, init_train_state, make_train_step

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step"]
