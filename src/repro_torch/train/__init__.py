from repro_torch.train.loop import (  # noqa: F401
    Trainer, TrainState, init_opt_state, make_train_step,
)
from repro_torch.train.plans import cnn_train_plan, lm_train_plan  # noqa: F401
