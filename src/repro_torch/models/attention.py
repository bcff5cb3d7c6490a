"""Plain grouped-query attention (the non-kernel route).

GQA is computed grouped -- queries reshaped to (B, S, KV, G, hd) -- so
repeated KV heads are never materialized.  Long query runs are split into
``chunk_q`` chunks; every query row's arithmetic is the same either way.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _band_mask(qpos, kpos, *, causal: bool, kv_len=None):
    """(Sq, Sk) bool mask -- or (B, Sq, Sk) when ``kv_len`` is per-row (B,).

    qpos/kpos are position vectors; a vector ``kv_len`` is the
    continuous-batching case where every batch row is a slot at its own
    sequence length.
    """
    m = torch.ones(qpos.shape[-1], kpos.shape[-1], dtype=torch.bool,
                   device=kpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if kv_len is not None:
        if not torch.is_tensor(kv_len) or kv_len.dim() == 0:
            m &= kpos[None, :] < kv_len
        else:
            m = m[None] & (kpos[None, None, :] < kv_len[:, None, None])
    return m


def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,KV,G,hd)  k,v: (B,Sk,KV,hd)  mask: (Sq,Sk) or (B,Sq,Sk)."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None, None, None]
    else:
        mask = mask[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def paged_gather(arena, bt):
    """A slot's dense cache view gathered from a page arena.

    arena: (n_pages, page, ...) shared pages; bt: (B, nblk) int block
    table (``n_pages`` is the sentinel of a block with no page).
    Sentinels clamp to the last page: its bytes sit at positions every
    caller masks away (per-row ``kv_len`` or the verify band), so their
    softmax weight is exactly 0.  Returns (B, nblk * page, ...), the dense
    pool layout.
    """
    n_pages = arena.shape[0]
    g = arena[bt.long().clamp(max=n_pages - 1)]  # (B, nblk, page, ...)
    return g.reshape((bt.shape[0], -1) + tuple(arena.shape[2:]))


def attention(q, k, v, *, causal=True, q_offset=0, kv_len=None, scale=None,
              chunk_q=512):
    """Grouped-query attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); returns (B, Sq, H, hd).
    ``q_offset`` -- absolute position of q[0] (cached prefill / decode).
    ``kv_len``   -- valid prefix length of k/v: an int, or a (B,) tensor of
    per-row lengths; rows with kv_len == 0 return exact zeros.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, Sq, chunk_q):
        c1 = min(c0 + chunk_q, Sq)
        qpos = q_offset + torch.arange(c0, c1, device=q.device)
        mask = _band_mask(qpos, kpos, causal=causal, kv_len=kv_len)
        outs.append(_sdpa(qg[:, c0:c1], k, v, mask, scale))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if torch.is_tensor(kv_len) and kv_len.dim() == 1:
        # rows with kv_len == 0 (idle/finished slots) have every key
        # masked; pin them to the kernel's semantics: exact zeros
        out = torch.where((kv_len > 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(B, Sq, H, v.shape[-1])
