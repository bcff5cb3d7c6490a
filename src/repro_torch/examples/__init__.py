"""The reference's examples on the port: ``quickstart`` (grow gpt-micro
into gpt-micro-big with Mango), ``grow_pipeline`` (pretrain, checkpoint,
grow from the checkpoint, resume) and ``train_100m`` (a 100M GPT, grown
from 25M).  Each runs as ``python -m repro_torch.examples.<name>``, on
CUDA unless given ``--device cpu``."""
