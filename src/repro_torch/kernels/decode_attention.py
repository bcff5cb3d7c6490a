"""Wrapper of the CUDA slot-decode kernel (``csrc/slot_decode_attention.cu``).

Checks what the kernel takes, allocates the output, launches on the
current stream and counts launches in ``slot_decode_attention.launches``.
``ops.slot_decode_attention`` routes CPU tensors to the plain version and
folds ``done`` rows into ``kv_len = 0`` before calling this.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)


def _entry():
    fn = build.load("slot_decode_attention").slot_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"slot_decode_attention: {name} must be a CUDA "
                             f"tensor on {q.device} (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"slot_decode_attention: {name} must be "
                             "contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"slot_decode_attention: {name} has dtype "
                            f"{t.dtype}; q, k, v must share float32 or "
                            "bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"slot_decode_attention: {name} must be 16-byte "
                             "aligned (vector loads)")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("slot_decode_attention: q must be (B, H, hd) and "
                         "k, v (B, S, KV, hd)")
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"slot_decode_attention: q {tuple(q.shape)} needs "
                         f"k, v of shape (B, S, KV, hd); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"slot_decode_attention: kv_len must be ({B},) "
                         f"int32 (got {tuple(kv_len.shape)} {kv_len.dtype})")
    if KV < 1 or H % KV or H // KV not in GROUPS:
        raise ValueError(f"slot_decode_attention: H/KV = {H}/{KV} must be "
                         f"one of {GROUPS}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"slot_decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")


def slot_decode_attention(q, k, v, kv_len):
    """q: (B, H, hd); k, v: (B, S, KV, hd) pool layout; kv_len: (B,) int32
    -> (B, H, hd).  kv_len 0 gives exact zeros; kv_len > S reads S."""
    _check(q, k, v, kv_len)
    B, H, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], B, k.shape[1], k.shape[2], H,
            hd, hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slot_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    slot_decode_attention.launches += 1
    return out


slot_decode_attention.launches = 0
