"""The training loop (:mod:`.trainer`)."""
from .trainer import TrainerConfig, train, make_train_step, TrainResult

__all__ = ["TrainerConfig", "train", "make_train_step", "TrainResult"]
