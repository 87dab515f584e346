"""Training of the port: trainer, checkpoints and the controller."""

from tfkaldi_tpu_torch.train.controller import NnetTrainOptions, TrainingController
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState

__all__ = ["NnetTrainOptions", "Trainer", "TrainerConfig", "TrainState", "TrainingController"]
