"""Wrapper of the CUDA linear-recurrence scan ``csrc/rglru_scan.cu``:
``h_t = a_t * h_{t-1} + b_t`` over the sequence, the RG-LRU core of
griffin's prefill.

It checks what the kernel takes, allocates the output, launches on the
current stream and counts launches in ``rglru_scan.launches``.  ``ops``
routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = build.load("rglru_scan").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W) float32 or bfloat16, contiguous, on one CUDA
    device; h0: (B, W) float32 or None (zeros) -> h (B, S, W) in a's
    dtype, carried in float32.  Any B, S, W.  Forward only: inputs that
    need a gradient are refused."""
    what = "rglru_scan"
    ts = [("a", a), ("b", b)] + ([] if h0 is None else [("h0", h0)])
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in ts):
        # the output would carry no gradient back to a, b and h0
        raise NotImplementedError(
            f"{what}: the kernel has no backward yet (griffin training, "
            "ROADMAP.md); run without gradients, or on the CPU")
    for name, t in ts:
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{a.device} (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"{what}: a and b must share one (B, S, W) shape "
                         f"(got {tuple(a.shape)}, {tuple(b.shape)})")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{what}: a, b have dtypes {a.dtype}, {b.dtype}; "
                        "both must be float32 or both bfloat16")
    B, S, W = a.shape
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (B, W)):
        raise ValueError(f"{what}: h0 must be ({B}, {W}) float32 (got "
                         f"{tuple(h0.shape)} {h0.dtype})")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = _entry()(a.data_ptr(), b.data_ptr(),
                      None if h0 is None else h0.data_ptr(), out.data_ptr(),
                      DTYPES[a.dtype], B, S, W,
                      torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
