from repro_torch.train.optimizer import Optimizer, adafactor, adamw, make_optimizer, sgdm
from repro_torch.train.train_step import build_train_step, init_train_state, make_train_state_specs
from repro_torch.train.trainer import Trainer, TrainMetrics

__all__ = [
    "Optimizer", "adafactor", "adamw", "make_optimizer", "sgdm",
    "build_train_step", "init_train_state", "make_train_state_specs",
    "Trainer", "TrainMetrics",
]
