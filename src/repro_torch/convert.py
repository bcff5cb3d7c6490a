"""Carry parameters between the reference package and the port.

Both packages lay params out as the same nested dict with the same leaf
names and shapes (stacked ``(L, ...)`` layer groups), so conversion is a
leaf-wise copy: ``from_jax`` takes the nested dict with array leaves (numpy
arrays, or anything ``np.asarray`` accepts) and returns tensors on
``device``; ``to_numpy`` goes the other way (bfloat16 leaves come back
as float32, exactly: numpy has no bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
