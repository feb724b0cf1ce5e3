from .step import TrainStep, build_train_step
from .loop import TrainLoop

__all__ = ["TrainStep", "build_train_step", "TrainLoop"]
