from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_schedule,
    linear_warmup_cosine,
)
