"""The training loop of the port: :mod:`.loop`."""

from .loop import TrainLoopConfig, TrainResult, make_train_step, train

__all__ = ["TrainLoopConfig", "make_train_step", "train", "TrainResult"]
