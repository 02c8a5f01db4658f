from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, masked, sgd, with_gradient_clipping,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_decay, exponential_epoch_decay, warmup_cosine,
)
