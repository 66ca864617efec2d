from repro_torch.training.optimizer import (  # noqa: F401
    OptState,
    adamw_init,
    adamw_update,
    adamw_update_,
    lr_schedule,
)
from repro_torch.training.train_step import make_train_step  # noqa: F401
