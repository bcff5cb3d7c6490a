from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    CheckpointShapeError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
