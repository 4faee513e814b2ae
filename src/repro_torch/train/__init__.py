"""repro_torch.train: the train step, the Trainer and the gradient-tap
dense layer (``sketched_dense``)."""
from repro_torch.train import sketched_dense  # noqa: F401
from repro_torch.train.train_step import (  # noqa: F401
    TrainConfig, TrainState, init_state, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
