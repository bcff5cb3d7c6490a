"""Public entry points of the attention kernels, dispatched on the device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor goes to the hand-written kernel, which raises on anything it does
not take.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import slot_decode_attention as _slot
from repro_torch.kernels.flash_attention import flash_attention as _flash


def flash_attention(q, k, v, *, causal=True):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _flash(q, k, v, causal=causal)


def slot_decode_attention(q, k, v, kv_len, *, done=None):
    """Full-KV slot decode over the pool layout (B, S, KV, hd).
    ``done`` rows are folded into ``kv_len = 0`` (exact-zero output)."""
    B = q.shape[0]
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(B)
    if done is not None:
        kv_len = torch.where(done, 0, kv_len)
    if q.device.type == "cpu":
        return ref.slot_decode_attention_ref(q, k, v, kv_len)
    return _slot(q, k, v, kv_len.contiguous())


def kernels():
    """The CUDA kernel wrappers of the serving path, by name (their
    ``launches`` counters are what a run reads)."""
    return {"flash_attention": _flash, "slot_decode_attention": _slot}
