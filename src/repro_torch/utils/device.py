"""Device choice for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU; asking for
CUDA where there is none raises instead of silently running elsewhere.
TF32 is switched off for matmuls and cuDNN: the port's float32 numbers are
held against float32 references, and TF32 keeps only ~3 decimal digits.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
