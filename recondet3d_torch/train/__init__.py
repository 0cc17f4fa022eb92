from recondet3d_torch.train.optim import Optimizer, build_optimizer, cyclic_schedule
from recondet3d_torch.train.trainer import Trainer, TrainState, make_train_step

__all__ = ["Optimizer", "build_optimizer", "cyclic_schedule", "Trainer", "TrainState", "make_train_step"]
