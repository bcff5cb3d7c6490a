"""Public entry points of the kernels, dispatched on the device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor goes to the hand-written kernel, which raises on anything it does
not take.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    chunk_verify_attention as _chunk,
)
from repro_torch.kernels.decode_attention import (
    decode_attention as _decode,
)
from repro_torch.kernels.decode_attention import (
    paged_chunk_verify_attention as _paged_chunk,
)
from repro_torch.kernels.decode_attention import (
    paged_ring_decode_attention as _paged_ring,
)
from repro_torch.kernels.decode_attention import (
    paged_slot_decode_attention as _paged_slot,
)
from repro_torch.kernels.decode_attention import ring_decode_attention as _ring
from repro_torch.kernels.decode_attention import slot_decode_attention as _slot
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru
from repro_torch.kernels.tr_sandwich import tr_sandwich as _sandwich


def flash_attention(q, k, v, *, causal=True):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _flash(q, k, v, causal=causal)


def decode_attention(q, k, v, kv_len, *, done=None):
    """One query per row over a head-major cache: q (B, H, hd); k, v
    (B, KV, S, hd), any strides with hd contiguous (the pool layout's
    ``transpose(1, 2)`` view reads without a copy); kv_len an int (one
    length for every row) or (B,).  ``done`` rows are folded into
    ``kv_len = 0`` (exact-zero output)."""
    B = q.shape[0]
    if isinstance(kv_len, int):
        kv_len = torch.full((B,), kv_len, dtype=torch.int32, device=q.device)
    else:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                                 device=q.device).reshape(-1).expand(B)
    if done is not None:
        kv_len = torch.where(done, 0, kv_len)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_len)
    return _decode(q, k, v, kv_len.contiguous())


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


def _positions(slot_positions, q, done):
    """(B,) int32 query positions with ``done`` rows folded into -1."""
    pos = torch.as_tensor(slot_positions, dtype=torch.int32,
                          device=q.device).reshape(-1).expand(q.shape[0])
    if done is not None:
        pos = torch.where(done, -1, pos)
    return pos.contiguous()


def ring_decode_attention(q, k, v, slot_positions, *, window, done=None):
    """Ring-buffer window slot decode over the pool layout: q (B, H, hd),
    k, v (B, ring, KV, hd) already holding this step at ``pos % ring``.
    ``done`` rows are folded into ``slot_positions = -1`` (exact-zero
    output)."""
    pos = _positions(slot_positions, q, done)
    if q.device.type == "cpu":
        return ref.ring_decode_attention_ref(q, k, v, pos, window=window)
    return _ring(q, k, v, pos, window=window)


def paged_ring_decode_attention(q, k, v, bt, slot_positions, *, window,
                                done=None):
    """Ring-buffer window slot decode over a paged pool: (n_pages, page,
    KV, hd) arenas through (B, nblk) block tables, ring modulus
    ``nblk * page``.  ``done`` rows fold into ``slot_positions = -1``."""
    pos = _positions(slot_positions, q, done)
    if q.device.type == "cpu":
        return ref.paged_ring_decode_attention_ref(q, k, v, bt, pos,
                                                   window=window)
    return _paged_ring(q, k, v, bt, pos, window=window)


def rglru_scan(a, b, h0=None):
    """The linear recurrence ``h_t = a_t * h_{t-1} + b_t``: a, b (B, S,
    W), h0 (B, W) float32 or None -> (B, S, W) in a's dtype."""
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    return _rglru(a, b, h0)


def chunk_verify_attention(q, ck, cv, k, v, offsets, *, ring, window=None,
                           done=None):
    """Speculative chunk-verify attention over the pool layout: S queries
    per row at ``offsets[b] + i`` over the read-only cache ``ck, cv``
    (B, Sc, KV, hd) and the chunk's own ``k, v`` (B, S, KV, hd).  ``done``
    rows are folded into ``offsets = -1`` (exact-zero output)."""
    B = q.shape[0]
    offsets = torch.as_tensor(offsets, dtype=torch.int32,
                              device=q.device).reshape(-1).expand(B)
    if done is not None:
        offsets = torch.where(done, -1, offsets)
    if q.device.type == "cpu":
        return ref.chunk_verify_attention_ref(q, ck, cv, k, v, offsets,
                                              ring=ring, window=window)
    return _chunk(q, ck, cv, k, v, offsets.contiguous(), ring=ring,
                  window=window)


def paged_slot_decode_attention(q, k, v, bt, kv_len, *, done=None):
    """Full-KV slot decode over a paged pool: (n_pages, page, KV, hd)
    arenas read through (B, nblk) block tables.  ``done`` rows fold into
    ``kv_len = 0`` as in the dense entry."""
    B = q.shape[0]
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(B)
    if done is not None:
        kv_len = torch.where(done, 0, kv_len)
    if q.device.type == "cpu":
        return ref.paged_slot_decode_attention_ref(q, k, v, bt, kv_len)
    return _paged_slot(q, k, v, bt, kv_len.contiguous())


def paged_chunk_verify_attention(q, ck, cv, bt, k, v, offsets, *, ring,
                                 window=None, done=None):
    """Speculative chunk verify over a paged pool (cache read-only).
    ``done`` rows fold into ``offsets = -1``."""
    B = q.shape[0]
    offsets = torch.as_tensor(offsets, dtype=torch.int32,
                              device=q.device).reshape(-1).expand(B)
    if done is not None:
        offsets = torch.where(done, -1, offsets)
    if q.device.type == "cpu":
        return ref.paged_chunk_verify_attention_ref(
            q, ck, cv, bt, k, v, offsets, ring=ring, window=window)
    return _paged_chunk(q, ck, cv, bt, k, v, offsets.contiguous(), ring=ring,
                        window=window)


def _sandwich_on_device(x, a_i, a_o):
    if x.device.type == "cpu":
        return ref.tr_sandwich_ref(x, a_i, a_o)
    return _sandwich(x, a_i, a_o)


class TrSandwich(torch.autograd.Function):
    """Y[n] = A_I^T X[n] A_O with its gradient.  Forward and dX run the
    sandwich (kernel on CUDA, plain version on the CPU); dA_I and dA_O are
    plain large products in f32."""

    @staticmethod
    def forward(ctx, x, a_i, a_o):
        ctx.save_for_backward(x, a_i, a_o)
        return _sandwich_on_device(x, a_i, a_o)

    @staticmethod
    def backward(ctx, dy):
        x, a_i, a_o = ctx.saved_tensors
        dy32 = dy.float()
        dx = da_i = da_o = None
        if ctx.needs_input_grad[0]:  # dX[n] = A_I dY[n] A_O^T, a sandwich
            dx = _sandwich_on_device(dy.contiguous().to(x.dtype),
                                     a_i.mT.contiguous(), a_o.mT.contiguous())
        if ctx.needs_input_grad[1]:  # dA_I = sum_n X[n] A_O dY[n]^T
            t = torch.matmul(x.float(), a_o.float())
            da_i = torch.einsum("nio,njo->ij", t, dy32).to(a_i.dtype)
        if ctx.needs_input_grad[2]:  # dA_O = sum_n X[n]^T A_I dY[n]
            u = torch.matmul(a_i.float(), dy32)
            da_o = torch.einsum("nik,nio->ko", x.float(), u).to(a_o.dtype)
        return dx, da_i, da_o


def tr_sandwich(x, a_i, a_o):
    """x: (N, D1i, D1o); a_i: (D1i, D2i); a_o: (D1o, D2o) ->
    (N, D2i, D2o) = a_i^T @ x[n] @ a_o in x's dtype, differentiable."""
    return TrSandwich.apply(x, a_i, a_o)


def kernels():
    """The CUDA kernel wrappers, by name (their ``launches`` counters are
    what a run reads)."""
    return {"flash_attention": _flash, "decode_attention": _decode,
            "slot_decode_attention": _slot,
            "tr_sandwich": _sandwich, "chunk_verify_attention": _chunk,
            "paged_slot_decode_attention": _paged_slot,
            "paged_chunk_verify_attention": _paged_chunk,
            "ring_decode_attention": _ring,
            "paged_ring_decode_attention": _paged_ring,
            "rglru_scan": _rglru}
