"""Carry parameters between the reference package and the port.

Both packages lay params out as the same nested dict with the same leaf
names and shapes (stacked ``(L, ...)`` layer groups), so conversion is a
leaf-wise copy: ``from_jax`` takes the nested dict with array leaves (numpy
arrays, or anything ``np.asarray`` accepts) and returns tensors on
``device``; a bfloat16 leaf (numpy's ``ml_dtypes`` type, which
``torch.from_numpy`` refuses) crosses bit for bit through its 16-bit
pattern.  ``to_numpy`` goes the other way (bfloat16 leaves come back as
float32, exactly: numpy has no bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
