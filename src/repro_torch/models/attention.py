"""Plain grouped-query attention (the non-kernel route), and the
ring-buffer window caches of local attention.

GQA is computed grouped -- queries reshaped to (B, S, KV, G, hd) -- so
repeated KV heads are never materialized.  Long query runs are split into
``chunk_q`` chunks; every query row's arithmetic is the same either way.
A causal ``window`` band attends ``(qpos - window, qpos]`` only, so each
chunk reads just the keys its band can reach.

A ring-buffer window cache holds ``ring`` slots per row (the padded
cache length, >= the window): slot ``s`` holds the largest position ``p``
written so far with ``p % ring == s``.  The slot-decode step writes each
row's K/V at ``pos % ring`` and attends by absolute position through
``ops.ring_decode_attention`` (dense pool) or
``ops.paged_ring_decode_attention`` (paged pool).  Speculative verify
writes a chunk of such steps and restores the rejected sites afterwards
(``paged_ring_restore_sites`` resolves them through a block table).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _band_mask(qpos, kpos, *, causal: bool, window=None, kv_len=None):
    """(Sq, Sk) bool mask -- or (B, Sq, Sk) when ``kv_len`` is per-row (B,).

    qpos/kpos are position vectors; a vector ``kv_len`` is the
    continuous-batching case where every batch row is a slot at its own
    sequence length.  ``window`` keeps keys in ``(qpos - window, qpos]``.
    """
    m = torch.ones(qpos.shape[-1], kpos.shape[-1], dtype=torch.bool,
                   device=kpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
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


def attention(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None,
              scale=None, chunk_q=512):
    """Grouped-query attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); returns (B, Sq, H, hd).
    ``q_offset`` -- absolute position of q[0] (cached prefill / decode).
    ``window``   -- causal local attention: keys in ``(qpos - window,
    qpos]`` (a chunk of queries reads only the keys its band reaches, so
    the work is O(Sq * window), not O(Sq * Sk)).
    ``kv_len``   -- valid prefix length of k/v: an int, or a (B,) tensor of
    per-row lengths; rows with kv_len == 0 return exact zeros.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Sk = k.shape[1]
    if scale is None:
        scale = hd ** -0.5
    if window is not None and not causal:
        raise ValueError("windowed attention requires causal=True")
    qg = q.reshape(B, Sq, KV, G, hd)
    outs = []
    for c0 in range(0, Sq, chunk_q):
        c1 = min(c0 + chunk_q, Sq)
        lo, hi = 0, Sk
        if window is not None:
            # the keys this chunk's bands reach (the mask keeps the rest
            # out; a key index is its absolute position)
            lo = min(max(0, q_offset + c0 - window + 1), Sk - 1)
            hi = max(min(Sk, q_offset + c1), lo + 1)
        qpos = q_offset + torch.arange(c0, c1, device=q.device)
        kpos = torch.arange(lo, hi, device=q.device)
        mask = _band_mask(qpos, kpos, causal=causal, window=window,
                          kv_len=kv_len)
        outs.append(_sdpa(qg[:, c0:c1], k[:, lo:hi], v[:, lo:hi], mask,
                          scale))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if torch.is_tensor(kv_len) and kv_len.dim() == 1:
        # rows with kv_len == 0 (idle/finished slots) have every key
        # masked; pin them to the kernel's semantics: exact zeros
        out = torch.where((kv_len > 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(B, Sq, H, v.shape[-1])


# ------------------------------------------------------ ring-buffer caches
def ring_positions_rows(cur_len, ring):
    """Absolute position held by each ring slot, PER ROW.

    cur_len: (B,) int -- positions written so far in each row.  Returns
    (B, ring) int32: slot ``s`` holds the largest ``p < cur_len`` with
    ``p % ring == s``, -1 for slots never written.  ``//`` floors, as the
    reference's does, so a row at length 0 reads as all unwritten.
    """
    slot = torch.arange(ring, dtype=torch.int32, device=cur_len.device)[None]
    cur = cur_len.to(torch.int32)[:, None]
    base = torch.div(cur - 1, ring, rounding_mode="floor") * ring + slot
    pos = torch.where(base < cur, base, base - ring)
    return torch.where(pos >= 0, pos, -1)


def ring_fill_rows(x, plens, ring, dtype):
    """Fill a ring cache from a bucket-padded prefill, PER ROW.

    x: (B, S, ...) per-position values (K or V) of a tail-padded prompt
    batch; plens: (B,) true prompt lengths.  Ring slot ``s`` of row ``b``
    gets the value at the largest real position ``p < plens[b]`` with
    ``p % ring == s`` (a gather, so wrapped positions never race in a
    scatter), 0 where never written.  Returns (B, ring, ...) in ``dtype``.
    """
    kpos = ring_positions_rows(plens, ring)  # (B, ring)
    shape = kpos.shape + (1,) * (x.dim() - 2)
    take = kpos.clamp(0, x.shape[1] - 1).long().reshape(shape).expand(
        (-1, -1) + tuple(x.shape[2:]))
    written = (kpos >= 0).reshape(shape)
    return torch.where(written, x.gather(1, take), 0).to(dtype)


def ring_slot_attend(q, ck, cv, slot_positions, *, window, scale=None,
                     done=None):
    """One-token attention over a ring cache at per-row positions, plain.

    q: (B, 1, H, hd); ck/cv: (B, ring, KV, hd) already holding this step's
    K/V at ``slot_positions[b] % ring``; slot_positions: (B,) each row's
    query position.  A slot is attended iff its position (from the ring
    invariant) lies in ``(qpos - window, qpos]``; ``done`` rows give exact
    zeros.  The model-level twin of ``ops.ring_decode_attention``.
    """
    B, Sq, H, hd = q.shape
    KV = ck.shape[2]
    ring = ck.shape[1]
    if scale is None:
        scale = hd ** -0.5
    kpos = ring_positions_rows(slot_positions + 1, ring)  # (B, ring)
    qpos = slot_positions[:, None]
    mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
    if done is not None:
        mask &= ~done[:, None]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    out = _sdpa(qg, ck.to(q.dtype), cv.to(q.dtype), mask[:, None, :], scale)
    if done is not None:
        out = torch.where(done[:, None, None, None, None], 0.0, out)
    return out.reshape(B, Sq, H, cv.shape[-1])


def ring_slot_update_attend(q, cache, k, v, slot_positions, *, window,
                            done=None):
    """One slot-decode step over a ring cache group, in place: write each
    live row's K/V at its ring slot ``pos % ring`` (``done`` rows write
    their old bytes back, so they keep them), then attend by absolute
    position through ``ops.ring_decode_attention``.

    cache: {"k", "v": (B, ring, KV, hd)}; q: (B, 1, H, hd); k, v:
    (B, 1, KV, hd) this step's projections.  Returns (B, 1, H, hd).
    """
    ck, cv = cache["k"], cache["v"]
    ring = ck.shape[1]
    rows = torch.arange(q.shape[0], device=q.device)
    sidx = (slot_positions % ring).long()
    for c, new in ((ck, k), (cv, v)):
        new = new[:, 0].to(c.dtype)
        if done is not None:
            new = torch.where(done[:, None, None], c[rows, sidx], new)
        c[rows, sidx] = new
    out = ops.ring_decode_attention(q[:, 0], ck.to(q.dtype), cv.to(q.dtype),
                                    slot_positions, window=window, done=done)
    return out[:, None]


def paged_ring_slot_update_attend(q, cache, k, v, slot_positions, *, window,
                                  done=None):
    """``ring_slot_update_attend`` over a PAGED ring cache group.

    cache: {"k", "v": (n_pages + 1, page, KV, hd) arenas, "bt": (B, nblk)};
    the ring modulus is ``nblk * page`` and row ``b``'s slot ``s`` lives at
    ``arena[bt[b, s // page], s % page]``.  A ``done`` row's write, and a
    write into a block the row never got (its table entry is the sentinel
    ``n_pages``), go to the scratch page ``n_pages``, which no read sees
    (``serve/paged.py``).  The attend reads the real pages through
    ``ops.paged_ring_decode_attention``.  Returns (B, 1, H, hd).
    """
    ck, cv, bt = cache["k"], cache["v"], cache["bt"]
    n_pages, page = ck.shape[0] - 1, ck.shape[1]
    ring = bt.shape[1] * page
    sidx = (slot_positions % ring).long()
    pid = bt.gather(1, (sidx // page)[:, None])[:, 0].long()
    if done is not None:
        pid = torch.where(done, n_pages, pid)
    off = sidx % page
    ck[pid, off] = k[:, 0].to(ck.dtype)
    cv[pid, off] = v[:, 0].to(cv.dtype)
    out = ops.paged_ring_decode_attention(
        q[:, 0], ck[:n_pages].to(q.dtype), cv[:n_pages].to(q.dtype), bt,
        slot_positions, window=window, done=done)
    return out[:, None]


def paged_ring_restore_sites(bt, positions, n_feed, chunk_len, page,
                             n_pages):
    """Scatter sites for the paged speculative ring ROLLBACK.

    A verify scan writes the whole chunk into the paged ring through the
    block table; commit must re-store the PRE-chunk bytes at every
    rejected write site (``j >= n_feed[b]``).  Returns (pid_restore,
    pid_read, off), each (B, chunk): ``pid_read`` is the clamped physical
    page to read old bytes from, ``pid_restore`` aims accepted sites (and
    blocks the row never got) at page ``n_pages`` -- the scratch page of
    the port's arenas, where the reference's scatter drops them -- and
    ``off`` is the in-page offset.  Requires ``chunk_len <= ring`` (the
    speculative pair probe enforces ``d + 1 <= window``) so no ring slot
    is written twice within one chunk.
    """
    ring = bt.shape[1] * page
    j = torch.arange(chunk_len, dtype=positions.dtype,
                     device=positions.device)
    sidx = (positions[:, None] + j[None]) % ring  # (B, chunk)
    pid = bt.gather(1, (sidx // page).long())
    rejected = j[None] >= n_feed[:, None]
    pid_restore = torch.where(rejected, pid, n_pages)
    pid_read = pid.clamp(max=n_pages - 1)
    return pid_restore, pid_read, sidx % page
