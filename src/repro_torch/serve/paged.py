"""Paged slot pool: block tables over a shared page arena.

The dense slot pool reserves a full ``(capacity, max_len)`` cache row per
slot.  This module re-lays every cache group a family DECLARES pageable
(``models.paged_groups``, part of the slot-state protocol) as a shared
page arena plus per-slot block tables:

    seq   dense {"k": (L, B, S, KV, hd), "v": ...}
          paged {"k": (L, n_pages + 1, page, KV, hd), "v": ...,
                 "bt": (L, B, nblk) int32}          nblk = S // page

with ``page`` the ``pad_cache_len`` quantum for ``S`` (8 up to 256, 64
above).  The block table rides inside the group dict, the same table for
every layer, so the layer loop hands layer ``i`` its ``bt[i]`` with no
extra plumbing; model code detects a paged group by ``"bt" in cache``.
A ``"seq"`` group pages a full-KV cache (the transformer's) or a ring
window cache (griffin's local attention, whose ring modulus is then
``nblk * page``).  Groups a family does not declare stay dense per slot
beside the paged ones (griffin's recurrent state: conv tails and RG-LRU
h, O(1) per slot) and ride the same admission and eviction scatters.
A windowed transformer's paged rings with prefix sharing
(``register_copy``, ``ring_restore_copy``) wait for their slice, and
``"slot"`` groups (xlstm tails) for the xlstm slice.

Page-id conventions
-------------------
* Page ids live in ``[0, n_pages)``; the value ``n_pages`` is the
  SENTINEL of a block that holds no page.  Gathers clamp it to the last
  real page: the bytes read there are finite and always sit behind a
  ``kv_len`` or verify-band mask, so their softmax weight is exactly 0.
* Dropped writes.  The reference scatters through the sentinel with
  out-of-bounds-drop semantics; PyTorch indexing refuses an out-of-range
  index (on the card, a device-side assert that ends the process).  So
  every arena carries ONE scratch page at index ``n_pages`` -- the
  sentinel itself -- and a write that must be dropped is aimed there: a
  ``done`` row's write, a draft proposal past the row's allocated pages
  (its table entry is the sentinel), a position at or past ``nblk *
  page``, a padding block of an admission, an uncommitted chunk entry.
  This takes no host sync and no boolean-mask indexing (a ``torch.where``
  on the page id).  The scratch page is never read: reads see the arena
  without it (``arena[:n_pages]``), so the sentinel clamps to page
  ``n_pages - 1`` as in the reference.  The budget, ``pages_in_use`` and
  ``--pages`` count real pages only.
* ONE page-id space spans every group of a pool and, for a speculative
  pair, both the target and draft pools: page ``p`` is row ``p`` of
  every arena of every engine sharing the allocator.  A request
  allocates ``pages_needed`` ids once and each group consumes the
  leading ``nblk_g`` of them, so draft and target memory trade freely
  inside one ``--pages`` budget.

The host-side :class:`PageAllocator` owns the free list, per-namespace
refcounts (one namespace per pool sharing the arena), and the prefix
registry (rolling blake2b chain hashes of full prompt pages).  Prefix
sharing needs no copy for full layouts: shared pages cover only FULL
pages strictly before a prompt's last token, and every write a slot
performs lands in its private tail pages.

The scatters below update the pool in place (``index_copy_`` /
``index_fill_``), where the reference returns new buffers that XLA
aliases through donation.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

RING_SLICE = ("paged ring caches of a windowed transformer (with their "
              "prefix sharing) are not ported to repro_torch yet (the "
              "windowed-transformer ring slice, ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class GroupMeta:
    """Static paging geometry of one declared cache group."""
    path: tuple      # key path to the group dict from the pool root
    kind: str        # "seq" (paged sequence axis)
    leaves: tuple    # arena leaf names inside the group dict
    page: int        # positions per page
    nblk: int        # block-table entries per slot


@dataclasses.dataclass(frozen=True)
class PoolMeta:
    """Static paging geometry of one pool.

    ``page``/``nblk`` summarize the pool for the engine: ``page`` is the
    shared sequence-group quantum, ``nblk`` the per-request allocation
    bound (max over groups).  ``groups`` carries the per-group layout; an
    empty tuple is the single-group geometry the allocator tests build.
    """
    page: int
    nblk: int
    n_pages: int     # real pages; also the sentinel / scratch page id
    groups: tuple = ()

    @property
    def sentinel(self) -> int:
        return self.n_pages


def page_quantum(padded_len: int) -> int:
    """The natural page size for a padded cache axis: the quantum
    ``pad_cache_len`` rounded to, re-derived from its output."""
    return 8 if padded_len <= 256 else 64


def require_full_layout(cfg):
    """Raise for a windowed transformer, whose paged rings (and their
    prefix sharing) are not ported; griffin's rings page."""
    if cfg.family == "transformer" and getattr(cfg, "window", None):
        raise NotImplementedError(f"{cfg.name}: {RING_SLICE}")


def pool_meta(cfg, cache_shapes: Any, pages: Optional[int] = None
              ) -> Optional[PoolMeta]:
    """Paging geometry for a pool, from a concrete pool or one built on
    the meta device (``init_cache(..., device="meta")``, the reference's
    ``jax.eval_shape``).  Reads the family's ``paged_groups``
    declaration; returns None when the family declares nothing pageable
    or its seq groups disagree on the padded sequence length."""
    from repro_torch import models

    require_full_layout(cfg)
    decl = models.paged_groups(cfg)
    groups = []
    seq_geom = set()
    B = None
    for key in sorted(decl):
        kind, leaves = decl[key]
        if key not in cache_shapes:
            continue
        if kind != "seq":
            raise NotImplementedError(
                f"{cfg.name}: paged {kind!r} cache groups are not ported to "
                "repro_torch yet (the xlstm slice, ROADMAP.md)")
        lead = cache_shapes[key][leaves[0]]
        B, S = lead.shape[1], lead.shape[2]
        page = page_quantum(S)
        if S % page:
            return None
        seq_geom.add((page, S // page))
        groups.append(GroupMeta(path=(key,), kind="seq",
                                leaves=tuple(leaves), page=page,
                                nblk=S // page))
    if not groups or len(seq_geom) > 1:
        return None
    page, nblk = seq_geom.pop()
    return PoolMeta(page=page, nblk=nblk,
                    n_pages=int(pages) if pages else B * nblk,
                    groups=tuple(groups))


def pool_fallback_reason(cfg) -> Optional[str]:
    """Why a config cannot serve paged, or None when it can."""
    from repro_torch import models

    if not models.paged_groups(cfg):
        return (f"{cfg.family} declares no pageable cache groups "
                "(O(1) recurrent state only)")
    return None


def build_paged_pool(fam, cfg, capacity: int, max_len: int,
                     pages: Optional[int] = None,
                     n_pages: Optional[int] = None, device="cpu"):
    """A zeroed paged pool for ``fam``/``cfg`` on ``device``.

    Returns ``(pool, meta)``; ``meta is None`` means the family declares
    nothing pageable and ``pool`` is the ordinary dense pool.  ``n_pages``
    sets the arena depth directly (a speculative pair shares one page-id
    space, so both pools are built to the same depth).  Each arena holds
    ``n_pages + 1`` pages: the last is the scratch page that absorbs
    dropped writes (module docstring).  Groups the family does not
    declare pageable are the dense pool's, zeroed.
    """
    require_full_layout(cfg)
    shapes = fam.init_cache(cfg, capacity, max_len, device="meta")
    meta = pool_meta(cfg, shapes, pages)
    if meta is None:
        return fam.init_cache(cfg, capacity, max_len, device=device), None
    if n_pages is not None and n_pages != meta.n_pages:
        meta = dataclasses.replace(meta, n_pages=int(n_pages))
    # undeclared groups (griffin's recurrent state) stay dense per slot
    out = {key: {lk: torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
                 for lk, leaf in grp.items()}
           for key, grp in _dense_groups(shapes, meta)}
    for g in meta.groups:
        grp = shapes[g.path[0]]
        if set(grp) != set(g.leaves):
            raise NotImplementedError(
                f"{cfg.name}: dense leaves inside a paged group are not "
                "ported to repro_torch yet (the xlstm slice, ROADMAP.md)")
        # (L, B, S, ...) -> (L, n_pages + 1, page, ...)
        og = {lk: torch.zeros((leaf.shape[0], meta.n_pages + 1, g.page)
                              + tuple(leaf.shape[3:]), dtype=leaf.dtype,
                              device=device) for lk, leaf in grp.items()}
        og["bt"] = torch.full((grp[g.leaves[0]].shape[0], capacity, g.nblk),
                              meta.sentinel, dtype=torch.int32, device=device)
        out[g.path[0]] = og
    return out, meta


def pages_needed(prompt_len: int, max_new: int, meta: PoolMeta) -> int:
    """Pages a request needs up front, so no mid-flight top-up is ever
    required: the max over the pool's groups, since every group consumes
    the leading ``nblk_g`` ids of one shared allocation.  The ``nblk``
    clamp covers both layouts: a full cache fits ``prompt + max_new``
    inside ``nblk`` pages by the engine's admission check, and a ring
    wraps at ``nblk * page``, so a long request needs every block of it
    and no more."""
    if not meta.groups:  # single-seq-group geometry
        return min(-(-(prompt_len + max_new) // meta.page), meta.nblk)
    return max(min(-(-(prompt_len + max_new) // g.page), g.nblk)
               for g in meta.groups)


# ------------------------------------------------------------- scatters
def _dense_groups(pool, meta: PoolMeta):
    """(key, group) of the pool's groups that the family did not declare
    pageable: they stay dense per slot."""
    paged_keys = {g.path[0] for g in meta.groups}
    return [(key, grp) for key, grp in pool.items() if key not in paged_keys]


def admit_scatter(pool, rows, slots, bt_rows, meta: PoolMeta):
    """Copy freshly prefilled dense cache rows into a paged pool, in place.

    rows: the matching DENSE tree of (L, n, S, ...) prefill rows (no
    "bt"); slots: (n,) int64 slot ids; bt_rows: (n, meta.nblk) int32 page
    ids per admitted row, each group consuming its leading ``nblk_g``
    columns; unallocated blocks carry the sentinel, so their chunks land
    in the scratch page.  Dense groups copy the rows into their slots.
    Only real rows are passed: PyTorch has no out-of-range drop for the
    reference's padding rows.
    """
    n = slots.shape[0]
    for key, grp in _dense_groups(pool, meta):
        for lk, leaf in grp.items():
            leaf.index_copy_(1, slots, rows[key][lk].to(leaf.dtype))
    for g in meta.groups:
        grp = pool[g.path[0]]
        bt_g = bt_rows[:, :g.nblk]
        grp["bt"].index_copy_(1, slots, bt_g[None].expand(
            grp["bt"].shape[0], n, g.nblk).to(torch.int32))
        flat = bt_g.reshape(-1).long()  # (n * nblk_g,)
        for lk in g.leaves:
            arena = grp[lk]
            chunks = rows[g.path[0]][lk].reshape(
                (arena.shape[0], n * g.nblk) + tuple(arena.shape[2:]))
            arena.index_copy_(1, flat, chunks.to(arena.dtype))
    return pool


def register_copy(pool, reg_pids, reg_blk, rows, meta: PoolMeta):
    """Ring prefix cache: copy prefill pages into registry-only pages."""
    raise NotImplementedError(f"register_copy: {RING_SLICE}")


def ring_restore_copy(pool, src_pids, dst_pids, meta: PoolMeta):
    """Ring prefix hit: rebuild a slot's ring from registered pages."""
    raise NotImplementedError(f"ring_restore_copy: {RING_SLICE}")


def evict_clear(pool, slots, zero_pids, meta: PoolMeta):
    """Clear evicted slots in place.  Dense groups zero the slots' rows
    (a retired request's recurrent state does not outlive it); paged
    groups zero the handed-back pages listed in ``zero_pids``
    (prefix-registered pages are retained, so they are simply absent; a
    sentinel entry zeroes the scratch page) and reset the rows' block
    tables to the sentinel."""
    zero_pids = zero_pids.long()
    for _, grp in _dense_groups(pool, meta):
        for leaf in grp.values():
            leaf.index_fill_(1, slots, 0)
    for g in meta.groups:
        grp = pool[g.path[0]]
        grp["bt"].index_fill_(1, slots, meta.sentinel)
        for lk in g.leaves:
            grp[lk].index_fill_(1, zero_pids, 0)
    return pool


def set_block_tables(pool, slots, bt_rows, meta: PoolMeta):
    """Point admitted rows' block tables at pages without touching arena
    bytes: the prefix-hit admission path (leading entries alias resident
    pages; tail pages fill through masked decode steps)."""
    n = slots.shape[0]
    for g in meta.groups:
        bt = pool[g.path[0]]["bt"]
        bt.index_copy_(1, slots, bt_rows[:, :g.nblk][None].expand(
            bt.shape[0], n, g.nblk).to(bt.dtype))
    return pool


# -------------------------------------------------------- prefix hashing
def prefix_digests(tokens, page: int) -> list:
    """Rolling chain digests of each FULL page of a prompt.

    ``digest[j]`` commits to tokens ``[0, (j+1) * page)``: chaining means
    a page is only ever shared under an identical full prefix, never by
    content coincidence at different offsets.
    """
    toks = np.asarray(tokens, np.int64)
    out = []
    h = b""
    for j in range(len(toks) // page):
        h = hashlib.blake2b(
            h + toks[j * page:(j + 1) * page].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


# -------------------------------------------------------- host allocator
class PageAllocator:
    """Host-side page bookkeeping for one page-id space: free list,
    per-namespace refcounts, and the prefix registry with LRU retention
    of zero-ref registered pages (their bytes ARE the cached value; they
    are reclaimed lazily, oldest first, only when the free list runs
    dry).

    ``namespaces`` > 1 merges several pools' arenas into ONE id space
    (the speculative draft/target pair): page ``p`` is a row in every
    pool's arenas, each pool holds references in its own namespace, and
    the page returns to the free list only when EVERY namespace has
    released it.  The prefix registry lives in namespace 0 (the target).
    """

    def __init__(self, meta: PoolMeta, namespaces: int = 1):
        self.meta = meta
        self.namespaces = namespaces
        self.free: list[int] = list(range(meta.n_pages))[::-1]
        self.refcount = np.zeros((meta.n_pages, namespaces), np.int32)
        self.registry: dict[bytes, int] = {}       # digest -> page id
        self.page_key: dict[int, bytes] = {}       # page id -> digest
        self.lru: OrderedDict[int, None] = OrderedDict()
        self.highwater = 0

    def pages_in_use(self) -> int:
        return self.meta.n_pages - len(self.free) - len(self.lru)

    def available(self) -> int:
        return len(self.free) + len(self.lru)

    def alloc(self, n: int, ns=(0,)) -> Optional[list]:
        """Take ``n`` pages (refcount 1 in each namespace of ``ns``),
        reclaiming retained prefix pages oldest first when the free list
        runs dry.  Returns None, allocating NOTHING, when fewer than
        ``n`` are available: admission backpressure is all-or-nothing."""
        if n > self.available():
            return None
        out = []
        for _ in range(n):
            if self.free:
                pid = self.free.pop()
            else:
                pid, _ = self.lru.popitem(last=False)
                self._unregister(pid)
            for i in ns:
                self.refcount[pid, i] = 1
            out.append(pid)
        self.highwater = max(self.highwater, self.pages_in_use())
        return out

    def incref(self, pids, ns: int = 0) -> None:
        for pid in pids:
            if self.refcount[pid].sum() == 0:
                # a retained registry page comes back to life
                self.lru.pop(pid, None)
            self.refcount[pid, ns] += 1
        self.highwater = max(self.highwater, self.pages_in_use())

    def release(self, pids, ns: int = 0) -> list:
        """Drop one reference per page in namespace ``ns``; returns the
        page ids whose bytes must be ZEROED (every namespace's count hit
        zero and the page is not prefix-registered; registered pages are
        retained in the LRU with their bytes intact)."""
        zero = []
        for pid in pids:
            self.refcount[pid, ns] -= 1
            if self.refcount[pid].sum() > 0:
                continue
            if pid in self.page_key:
                self.lru[pid] = None
                self.lru.move_to_end(pid)
            else:
                self.free.append(pid)
                zero.append(pid)
        return zero

    def _unregister(self, pid: int) -> None:
        d = self.page_key.pop(pid, None)
        if d is not None:
            self.registry.pop(d, None)

    def register(self, digests, pids) -> None:
        """Record ``pids[j]`` as holding the page whose chain digest is
        ``digests[j]``.  First writer wins: re-registering a digest that
        already resolves elsewhere is a no-op."""
        for d, pid in zip(digests, pids):
            if d in self.registry or pid in self.page_key:
                continue
            self.registry[d] = pid
            self.page_key[pid] = d

    def flush_registry(self) -> list:
        """Drop the entire prefix registry (after a poisoned slot, no
        resident prefix can be trusted).  Zero-ref retained pages return
        to the free list and their ids are returned for zeroing; pages
        still referenced are merely unregistered and are zeroed when
        their last reference drops."""
        zero = list(self.lru.keys())
        for pid in zero:
            self.free.append(pid)
        self.lru.clear()
        self.registry.clear()
        self.page_key.clear()
        return zero

    def lookup(self, digests) -> Optional[list]:
        """Resolve a chain of share digests to resident pages.  A partial
        chain is a miss: every looked-up position's bytes must be
        resident."""
        out = []
        for d in digests:
            pid = self.registry.get(d)
            if pid is None:
                return None
            out.append(pid)
        return out
