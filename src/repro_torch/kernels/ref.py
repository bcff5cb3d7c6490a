"""Plain PyTorch versions of the kernels (the allclose targets).

``ops`` routes CPU tensors here; ``chip_smoke.py`` holds each CUDA kernel
against these on the card.  All math runs in float32 and the result is cast
back to the input dtype, as in the reference package's oracles.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd)."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len):
    """q: (B, H, hd); k, v: (B, KV, S, hd) head-major (any strides);
    kv_len: an int or (B,) valid lengths -> (B, H, hd).  Rows with
    kv_len == 0 return exact zeros."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgh,bksh->bkgs", qg, k.float()) * hd ** -0.5
    kvl = torch.as_tensor(kv_len, device=q.device).reshape(-1).to(
        torch.int64).expand(B)
    mask = torch.arange(S, device=q.device)[None] < kvl[:, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    out = out * (kvl > 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, H, hd).to(q.dtype)


def slot_decode_attention_ref(q, k, v, kv_len):
    """q: (B, H, hd); k, v: (B, S, KV, hd) -- the slot pool's layout;
    kv_len: (B,) valid lengths -> (B, H, hd).  Rows with kv_len == 0 (idle
    or finished slots) return exact zeros."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * hd ** -0.5
    kvl = kv_len.reshape(-1).to(torch.int64).expand(B)
    mask = torch.arange(S, device=q.device)[None] < kvl[:, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    out = out * (kvl > 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, H, hd).to(q.dtype)


def tr_sandwich_ref(x, a_i, a_o):
    """x: (N, D1i, D1o); a_i: (D1i, D2i); a_o: (D1o, D2o) ->
    Y[n] = a_i^T @ x[n] @ a_o, (N, D2i, D2o) in x's dtype (f32 math)."""
    y = torch.einsum("nio,ij,om->njm", x.float(), a_i.float(), a_o.float())
    return y.to(x.dtype)


def _ring_kpos(cur_len, ring):
    """Absolute position held by each ring slot at per-row lengths.

    cur_len: (B,) -> (B, ring) int32, -1 where never written.  Slot s holds
    the largest p < cur_len with p % ring == s.  (Re-derived here rather
    than shared with the model code, so the oracle can catch a fault in
    either.)  ``//`` on tensors floors, as the reference's does, so a row
    with cur_len 0 wraps to -1 and every slot reads as never written.
    """
    slot = torch.arange(ring, dtype=torch.int32, device=cur_len.device)[None]
    cur = cur_len.to(torch.int32)[:, None]
    base = torch.div(cur - 1, ring, rounding_mode="floor") * ring + slot
    pos = torch.where(base < cur, base, base - ring)
    return torch.where(pos >= 0, pos, -1)


def ring_decode_attention_ref(q, k, v, slot_positions, *, window):
    """q: (B, H, hd); k, v: (B, ring, KV, hd) ring caches already holding
    this step at ``slot_positions[b] % ring``; slot_positions: (B,) query
    positions (-1: done -> exact zeros).  Attends the slots whose absolute
    position (from the ring invariant) lies in ``(pos - window, pos]``."""
    B, H, hd = q.shape
    ring, KV = k.shape[1], k.shape[2]
    G = H // KV
    pos = slot_positions.reshape(-1).to(torch.int32).expand(B)
    kpos = _ring_kpos(pos + 1, ring)  # (B, ring)
    mask = (kpos >= 0) & (kpos > pos[:, None] - window) & (pos >= 0)[:, None]
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * hd ** -0.5
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    out = out * (pos >= 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, H, hd).to(q.dtype)


def chunk_verify_attention_ref(q, ck, cv, k, v, offsets, *, ring,
                               window=None):
    """q: (B, S, H, hd); ck, cv: (B, Sc, KV, hd) read-only cache; k, v:
    (B, S, KV, hd) the chunk's own K/V; offsets: (B,) committed lengths
    (-1: done -> exact zeros).  Query i of row b sits at offsets[b] + i and
    attends [cache ‖ chunk] by absolute position: causal, and within
    ``(qpos - window, qpos]`` when a window is given.  ``ring`` picks the
    ring-buffer reconstruction of the cache's key positions."""
    B, S, H, hd = q.shape
    Sc, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    dev = q.device
    off = offsets.reshape(-1).to(torch.int32).expand(B)
    if ring:
        kpos_cache = _ring_kpos(off, Sc)
    else:
        pos = torch.arange(Sc, dtype=torch.int32, device=dev)[None]
        kpos_cache = torch.where(pos < off[:, None], pos, -1)
    steps = torch.arange(S, dtype=torch.int32, device=dev)[None]
    kpos = torch.cat([kpos_cache, off[:, None] + steps], 1)  # (B, Sc + S)
    qpos = off[:, None] + steps  # (B, S)
    mask = ((kpos[:, None] >= 0) & (kpos[:, None] <= qpos[:, :, None])
            & (off >= 0)[:, None, None])
    if window is not None:
        mask &= kpos[:, None] > qpos[:, :, None] - window
    k_all = torch.cat([ck.float(), k.float()], 1)  # (B, Sc + S, KV, hd)
    v_all = torch.cat([cv.float(), v.float()], 1)
    qg = q.reshape(B, S, KV, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k_all) * hd ** -0.5
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v_all)
    out = out * (off >= 0).to(out.dtype)[:, None, None, None, None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def _paged_gather_ref(arena, bt):
    """(n_pages, page, ...) arena + (B, nblk) block table -> the dense
    pool layout (B, nblk * page, ...).  Sentinel entries clamp to the last
    page, whose bytes sit at positions every paged version masks away (an
    independent twin of ``models.attention.paged_gather``, re-derived so
    the plain versions can catch a fault in either)."""
    n_pages = arena.shape[0]
    bt = bt.long()
    g = arena[torch.where(bt < n_pages, bt, n_pages - 1)]
    return g.reshape((bt.shape[0], -1) + tuple(arena.shape[2:]))


def paged_slot_decode_attention_ref(q, k, v, bt, kv_len):
    """q: (B, H, hd); k, v: (n_pages, page, KV, hd) arenas; bt: (B, nblk)
    block tables; kv_len: (B,) -> (B, H, hd): the dense version over the
    gathered view."""
    return slot_decode_attention_ref(
        q, _paged_gather_ref(k, bt), _paged_gather_ref(v, bt), kv_len)


def paged_ring_decode_attention_ref(q, k, v, bt, slot_positions, *,
                                    window):
    """The ring version over (n_pages, page, KV, hd) arenas read through
    (B, nblk) block tables (ring modulus ``nblk * page``)."""
    return ring_decode_attention_ref(
        q, _paged_gather_ref(k, bt), _paged_gather_ref(v, bt),
        slot_positions, window=window)


def paged_chunk_verify_attention_ref(q, ck, cv, bt, k, v, offsets, *, ring,
                                     window=None):
    """The chunk-verify version over (n_pages, page, KV, hd) cache arenas
    and (B, nblk) block tables (logical cache length ``nblk * page``)."""
    return chunk_verify_attention_ref(
        q, _paged_gather_ref(ck, bt), _paged_gather_ref(cv, bt), k, v,
        offsets, ring=ring, window=window)


def rglru_scan_ref(a, b, h0=None):
    """The linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over the
    sequence, one step at a time in float32 (a product, then a sum, each
    rounded).  a, b: (B, S, W); h0: (B, W) float32 or None (zeros) ->
    h: (B, S, W) in a's dtype."""
    h = (torch.zeros(a[:, 0].shape, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
