from .checkpoint import latest_step, load_checkpoint, save_checkpoint
from .optimizer import OptimizerConfig, make_optimizer
from .step import TrainConfig, make_train_step

__all__ = [
    "latest_step", "load_checkpoint", "save_checkpoint",
    "OptimizerConfig", "make_optimizer",
    "TrainConfig", "make_train_step",
]
