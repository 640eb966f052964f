from .augment import (  # noqa: F401
    AUGPIPE_SPECS,
    AugmentConfig,
    GeneratorDraws,
    make_augment_pipe,
)
from .loss import GANLoss, LossConfig  # noqa: F401
from .train_step import (  # noqa: F401
    OptimizerConfig,
    TrainState,
    TrainingConfig,
    init_train_state,
    make_train_step,
)
