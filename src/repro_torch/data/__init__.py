from repro_torch.data.synthetic import (  # noqa: F401
    frames_batch,
    lm_batch,
    lm_data_iter,
    vision_batch,
)
