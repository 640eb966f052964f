from .loss import GANLoss, LossConfig  # noqa: F401
from .train_step import (  # noqa: F401
    OptimizerConfig,
    TrainState,
    TrainingConfig,
    init_train_state,
    make_train_step,
)
