from repro_torch.data.synthetic import lm_batch, lm_data_iter  # noqa: F401
