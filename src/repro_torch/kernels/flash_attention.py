"""Wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Checks what the kernel takes, allocates the output, launches on the
current stream and counts launches in ``flash_attention.launches``.
``ops.flash_attention`` routes CPU tensors to the plain version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def _entry():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"on {q.device} (got {t.device})")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}; "
                            "q, k, v must share float32 or bfloat16")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D with a "
                             f"contiguous last axis (shape {tuple(t.shape)}, "
                             f"strides {t.stride()})")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k, v of "
                         f"shape (B, KV, S, hd); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v rows must start on "
                         "16 bytes (the kernel copies them by TMA)")


def flash_attention(q, k, v, *, causal=True):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) CUDA tensors (any strides with
    a contiguous last axis) -> (B, H, S, hd), laid out like q."""
    _check(q, k, v)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, H, k.shape[1], S, hd,
            ctypes.addressof(strides), hd ** -0.5, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
