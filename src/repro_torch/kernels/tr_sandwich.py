"""Wrapper of the CUDA Mango sandwich kernel (``csrc/tr_sandwich.cu``).

Checks what the kernel takes, allocates the output, launches on the
current stream and counts launches in ``tr_sandwich.launches``.
``ops.tr_sandwich`` routes CPU tensors to the plain version and carries the
gradient (``ops.TrSandwich``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TO = 32  # columns of Y per block; the kernel stages D1i x TO floats of T
BK = 16  # contraction depth of one shared-memory step
# shared memory a block may use on an H100, and what the kernel's A/B
# staging tiles take beside T (16 x 260 + 16 x 32 floats)
SMEM_LIMIT = 232448
SMEM_TILES = (BK * 260 + BK * TO) * 4
MAX_N = 65535  # N is the grid's y axis


def smem_bytes(d1i: int) -> int:
    """Dynamic shared memory of one block for a contraction depth d1i."""
    return -(-d1i // BK) * BK * TO * 4 + SMEM_TILES


def _entry():
    fn = build.load("tr_sandwich").tr_sandwich_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, a_i, a_o):
    for name, t in (("x", x), ("a_i", a_i), ("a_o", a_o)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"tr_sandwich: {name} must be a CUDA tensor on "
                             f"{x.device} (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"tr_sandwich: {name} must be contiguous")
        if t.dtype != x.dtype or t.dtype not in DTYPES:
            raise TypeError(f"tr_sandwich: {name} has dtype {t.dtype}; x, "
                            "a_i, a_o must share float32 or bfloat16")
    if x.dim() != 3 or a_i.dim() != 2 or a_o.dim() != 2:
        raise ValueError("tr_sandwich: x must be (N, D1i, D1o), a_i "
                         "(D1i, D2i) and a_o (D1o, D2o)")
    N, d1i, d1o = x.shape
    if a_i.shape[0] != d1i or a_o.shape[0] != d1o:
        raise ValueError(f"tr_sandwich: x {tuple(x.shape)} needs a_i with "
                         f"{d1i} rows and a_o with {d1o} rows; got "
                         f"{tuple(a_i.shape)}, {tuple(a_o.shape)}")
    if N > MAX_N:
        raise ValueError(f"tr_sandwich: N {N} exceeds the grid's {MAX_N}")
    if smem_bytes(d1i) > SMEM_LIMIT:
        raise ValueError(f"tr_sandwich: staging T (D1i {d1i} x {TO}) needs "
                         f"{smem_bytes(d1i)} bytes of shared memory, more "
                         f"than a block's {SMEM_LIMIT}")


def tr_sandwich(x, a_i, a_o):
    """x: (N, D1i, D1o); a_i: (D1i, D2i); a_o: (D1o, D2o) ->
    Y[n] = a_i^T @ x[n] @ a_o, (N, D2i, D2o) in x's dtype, f32 sums."""
    _check(x, a_i, a_o)
    N, d1i, d1o = x.shape
    d2i, d2o = a_i.shape[1], a_o.shape[1]
    y = torch.empty((N, d2i, d2o), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), a_i.data_ptr(), a_o.data_ptr(), y.data_ptr(),
            DTYPES[x.dtype], N, d1i, d1o, d2i, d2o, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tr_sandwich kernel launch failed: CUDA error "
                           f"{rc}")
    tr_sandwich.launches += 1
    return y


tr_sandwich.launches = 0
