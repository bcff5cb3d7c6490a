"""The reference's examples on the port: ``quickstart`` (grow gpt-micro
into gpt-micro-big with Mango), ``grow_pipeline`` (pretrain, checkpoint,
grow from the checkpoint, resume), ``train_100m`` (a 100M GPT, grown
from 25M), ``serve_continuous`` (three families through the engine) and
``serve_batched`` (three families through ``generate``).  Each runs as ``python -m repro_torch.examples.<name>``, on
CUDA unless given ``--device cpu``."""
