"""Wrappers of the CUDA linear-recurrence scan ``csrc/rglru_scan.cu``:
``h_t = a_t * h_{t-1} + b_t`` over the sequence, the RG-LRU core of
griffin's prefill and training, and its backward (``rglru_scan_bwd``).

Each checks what its kernel takes, plans the launch (``scan_plan``),
allocates the outputs, launches on the current stream and counts launches
in ``<wrapper>.launches``.  ``ops`` routes CPU tensors to the plain
versions and binds the two as one ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _sm_count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SCAN_LANES = 32  # lanes a tile of the TMA path (LANES in the .cu)
SCAN_STAGES = 4  # stages of a and b in flight a tile (NS in the .cu)
# shared memory the resident blocks of an SM share (an H100 SM has 228 KB,
# 1 KB of it reserved a block), and the blocks an SM is planned to hold at
# most (more tiles run in waves)
SCAN_SMEM_SM = 220 * 1024
SCAN_BLOCKS_SM = 8
SCAN_STEPS = (8, 256)  # steps a stage: a TMA box's rows, at most 256
LANES_BLOCK = 32 * 4  # lanes a block of the per-lane path (NT in the .cu)


def scan_smem(steps, itemsize, bwd=False):
    """Shared memory of a TMA-path block: 128 bytes of barriers, then
    SCAN_STAGES stages of a and b and two output tiles (forward), or
    SCAN_STAGES stages of h (float32), a and g and two tiles each of da and
    db (``bwd``)."""
    if bwd:
        per = SCAN_STAGES * (2 * itemsize + 4) + 4 * itemsize
    else:
        per = (2 * SCAN_STAGES + 2) * itemsize
    return 128 + per * steps * SCAN_LANES


def scan_plan(B, S, W, itemsize, n_sm, ptrs=(), bwd=False):
    """(steps, blocks) of the scan's one launch over (B, S, W).

    Rows of W * itemsize bytes on 16 and every address in ``ptrs`` (the
    tensors' data pointers) too: the TMA path, one block a tile of
    SCAN_LANES lanes of one row (B * ceil(W / 32) blocks), walking the
    sequence ``steps`` steps a stage (a power of two, 8..256): as many as
    the shared memory of an SM gives each of the blocks it holds at once
    (ceil(blocks / n_sm), at most SCAN_BLOCKS_SM), and no more than S
    needs.  Otherwise (the TMA unit takes no row off 16 bytes) steps is 0:
    the per-lane path, one thread a lane in blocks of LANES_BLOCK.
    ``bwd`` plans the backward, whose stages also hold a float32 h."""
    if W * itemsize % 16 or any(p % 16 for p in ptrs):
        return 0, -(-B * W // LANES_BLOCK)
    blocks = B * -(-W // SCAN_LANES)
    per_sm = min(SCAN_BLOCKS_SM, max(1, -(-blocks // n_sm)))
    steps, most = SCAN_STEPS
    while (steps < most and steps < S
           and per_sm * scan_smem(2 * steps, itemsize, bwd) <= SCAN_SMEM_SM):
        steps *= 2
    return steps, blocks


def _entry():
    fn = build.load("rglru_scan").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(what, ts):
    first = ts[0][1]
    for name, t in ts:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{first.device} (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W) float32 or bfloat16, contiguous, on one CUDA
    device; h0: (B, W) float32 or None (zeros) -> h (B, S, W) in a's
    dtype, carried in float32.  Any B, S, W, in one launch planned by
    ``scan_plan``.  The output carries no graph: ``ops.rglru_scan`` binds
    this and ``rglru_scan_bwd`` into an autograd function."""
    what = "rglru_scan"
    _check_cuda(what, [("a", a), ("b", b)]
                + ([] if h0 is None else [("h0", h0)]))
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
    steps, _ = scan_plan(B, S, W, a.element_size(), _sm_count(a.device),
                         [t.data_ptr() for t in (a, b, out)])
    with torch.cuda.device(a.device):
        rc = _entry()(a.data_ptr(), b.data_ptr(),
                      None if h0 is None else h0.data_ptr(), out.data_ptr(),
                      DTYPES[a.dtype], B, S, W, steps,
                      torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def _bwd_entry():
    fn = build.load("rglru_scan").rglru_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan_bwd(a, g, h, h0=None, need_dh0=True):
    """The scan's backward.  a, g (upstream dL/dh): (B, S, W) in one of
    float32 or bfloat16; h: (B, S, W) float32, the forward's h carried in
    float32; h0: (B, W) float32 or None -> (da, db) in a's dtype, and dh0
    (B, W) float32 (None without h0 or with ``need_dh0`` False).  All
    contiguous on one CUDA device; one launch planned by ``scan_plan``."""
    what = "rglru_scan_bwd"
    ts = [("a", a), ("g", g), ("h", h)] + (
        [] if h0 is None else [("h0", h0)])
    _check_cuda(what, ts)
    if a.dim() != 3 or g.shape != a.shape or h.shape != a.shape:
        raise ValueError(f"{what}: a, g and h must share one (B, S, W) "
                         f"shape (got {tuple(a.shape)}, {tuple(g.shape)}, "
                         f"{tuple(h.shape)})")
    if a.dtype not in DTYPES or g.dtype != a.dtype:
        raise TypeError(f"{what}: a, g have dtypes {a.dtype}, {g.dtype}; "
                        "both must be float32 or both bfloat16")
    if h.dtype != torch.float32:
        raise TypeError(f"{what}: h must be float32 (got {h.dtype})")
    B, S, W = a.shape
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (B, W)):
        raise ValueError(f"{what}: h0 must be ({B}, {W}) float32 (got "
                         f"{tuple(h0.shape)} {h0.dtype})")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = (torch.empty((B, W), dtype=torch.float32, device=a.device)
           if h0 is not None and need_dh0 else None)
    steps, _ = scan_plan(B, S, W, a.element_size(), _sm_count(a.device),
                         [t.data_ptr() for t in (a, g, h, da, db)], bwd=True)
    with torch.cuda.device(a.device):
        rc = _bwd_entry()(
            a.data_ptr(), g.data_ptr(), h.data_ptr(),
            None if h0 is None else h0.data_ptr(), da.data_ptr(),
            db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
            DTYPES[a.dtype], B, S, W, steps,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    rglru_scan_bwd.launches += 1
    return da, db, dh0


rglru_scan_bwd.launches = 0
