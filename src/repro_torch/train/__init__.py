"""The training loop of the port: :mod:`.loop`."""

from .loop import TrainLoopConfig, TrainResult, expandable_segments, make_train_step, train

__all__ = [
    "TrainLoopConfig", "expandable_segments", "make_train_step", "train", "TrainResult",
]
