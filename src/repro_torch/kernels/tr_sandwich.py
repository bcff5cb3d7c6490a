"""Wrapper of the CUDA Mango sandwich kernel (``csrc/tr_sandwich.cu``).

Checks what the kernel takes, allocates the output and the kernel's
scratch (A_I and A_O cut into its shared-memory tiles, which the C entry
point fills before the sandwich), launches on the current stream and
counts launches in ``tr_sandwich.launches`` (one per call).
``ops.tr_sandwich`` routes CPU tensors to the plain version and carries the
gradient (``ops.TrSandwich``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TO = 64  # columns of Y per block; the kernel holds T^T (TO x D1i) in f32
NB = 128  # B-operand rows of a pipeline stage
RING = 3  # slots in the kernel's ring
# shared memory a block may use on an H100
SMEM_LIMIT = 232448
# the shallow stage the kernel takes where T leaves no room for its deep
# one (elements along K)
MIN_DEPTH = {torch.float32: 8, torch.bfloat16: 16}
MAX_N = 65535  # N is the grid's y axis


def smem_bytes(d1i: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block for a contraction depth d1i at
    the shallow stage (the least the kernel needs): T^T in f32, a ring of
    slots aligned to 1 KB, each the larger of product 1's A_O^T tile plus
    NB rows of X and product 2's A_I^T tile (B tiles: TF32 hi and lo planes
    in f32, one plane in bf16), and the ring's barriers."""
    t_bytes = TO * (-(-d1i // 64) * 64 + 4) * 4
    kt, es = MIN_DEPTH[dtype], dtype.itemsize
    planes = 2 if dtype == torch.float32 else 1
    slot = max(TO * kt * es * planes + NB * kt * es, NB * kt * es * planes)
    return t_bytes + 1024 + RING * (slot + 16)


def _entries():
    lib = build.load("tr_sandwich")
    fn, scratch = lib.tr_sandwich_fwd, lib.tr_sandwich_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        scratch.argtypes = [ctypes.c_int] * 5
        scratch.restype = ctypes.c_longlong
    return fn, scratch


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
    if smem_bytes(d1i, x.dtype) > SMEM_LIMIT:
        raise ValueError(f"tr_sandwich: holding T (D1i {d1i} x {TO}) needs "
                         f"{smem_bytes(d1i, x.dtype)} bytes of shared "
                         f"memory, more than a block's {SMEM_LIMIT}")


def tr_sandwich(x, a_i, a_o):
    """x: (N, D1i, D1o); a_i: (D1i, D2i); a_o: (D1o, D2o) ->
    Y[n] = a_i^T @ x[n] @ a_o, (N, D2i, D2o) in x's dtype, f32 sums."""
    _check(x, a_i, a_o)
    N, d1i, d1o = x.shape
    d2i, d2o = a_i.shape[1], a_o.shape[1]
    y = torch.empty((N, d2i, d2o), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn, scratch_bytes = _entries()
    dtype = DTYPES[x.dtype]
    # the kernel's scratch: A_I and A_O cut into its shared-memory tiles
    scratch = torch.empty(scratch_bytes(dtype, d1i, d1o, d2i, d2o),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), a_i.data_ptr(), a_o.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), dtype, N, d1i, d1o, d2i, d2o,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tr_sandwich kernel launch failed: CUDA error "
                           f"{rc}")
    tr_sandwich.launches += 1
    return y


tr_sandwich.launches = 0
