"""Training of the port (``repro/train``): the step, and the
fault-tolerant loop in ``train.loop``."""

from .step import TrainConfig, TrainState, init_train_state, make_train_step

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step"]
