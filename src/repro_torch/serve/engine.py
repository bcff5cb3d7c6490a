"""Continuous-batching serve engine with on-device macro-step decode.

The engine serves a stream of requests through a fixed-capacity slot
pool, greedy, on the dense pool layout of the reference package:

  * ``Request``       -- prompt + max_new_tokens (+ optional eos, and an
                         arrival time that ``step(now)`` admits by);
  * slot pool         -- one ``fam.init_cache(cfg, capacity, max_len)``
                         allocation; row ``i`` is an independent sequence
                         slot, written at admission, advanced per step at
                         its own length, and zeroed at retirement;
  * batched admission -- arrived requests sharing a prefill bucket prefill
                         in ONE multi-row call (group padded to a power of
                         two) and are copied into their slots; the policy
                         picks who goes first when slots are scarce (FIFO,
                         or length-bucketed shortest-prefill-first);
  * macro-step loop   -- ``make_slot_decode_loop(cfg, k)`` runs K decode
                         steps per dispatch with per-slot eos / budget
                         stopping on the device; the host reads back one
                         ``(K, capacity)`` token block per dispatch;
  * double buffering  -- ``run()`` enqueues block N+1 before it waits on
                         block N: each block is copied to pinned host
                         memory with ``non_blocking=True`` behind a CUDA
                         event, so the readback overlaps the next block
                         (``step()`` is the synchronous single iteration);
  * paged mode        -- ``pool="paged"`` re-lays the pool as shared page
                         arenas plus per-slot block tables
                         (``serve/paged.py``): a request reserves the pages
                         it needs up front (all-or-nothing: without them
                         it waits in the queue), full prompt pages are
                         registered by a chained digest, and a later
                         prompt that opens with the same full pages
                         aliases them (refcounted) and runs only its
                         private tail through masked decode steps, with no
                         prefill; ``pages`` sets the arena's page budget;
  * speculative mode  -- a ``SpeculativeConfig`` swaps the macro loop for
                         ``make_speculative_loop``: a small DRAFT model
                         proposes d tokens per slot and the target
                         verifies them in one chunk forward, so a dispatch
                         of K blocks emits up to K*(d+1) tokens per slot
                         with the same single host sync.  The engine then
                         runs TWO slot pools (target + draft), admits and
                         evicts rows in both, and reads the acceptance
                         telemetry back with the token block.  A draft
                         whose logits go non-finite drops the engine to
                         the plain macro loop on the target pool
                         (degradation ladder, ``n_spec_fallbacks``).  On
                         a paged pool both pools share ONE page-id space
                         and budget; prefix sharing stays off.

Everything runs on the device the params live on.  Buffers the reference
package donates to XLA are updated in place here (``index_copy_`` /
``index_fill_`` on the pool and the decode state).  Padding rows of an
admission group target no slot: the reference scatters them to the
out-of-range index ``capacity``, which XLA drops and PyTorch indexing
would refuse, so only the first ``n`` rows are copied.

The engine serves any family of the slot-state protocol: the transformer
(full KV) and griffin (recurrent state, dense per slot, beside ring-window
local-attention caches, which page on a paged pool).  Greedy tokens are
the sequential ``generate()`` tokens for every request, for any
interleaving, any K, any speculation depth and either pool, up to float
near-ties between the routes' arithmetic.  Sampling, deadlines, faults,
the journal, live upgrade and meshes are not ported yet, nor are a
windowed transformer's paged rings and the paged arena's
full-reservation degradation rung (the faults slice).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import get_family, serve_supported, slot_cache_layout
from repro_torch.serve import paged as paged_lib
from repro_torch.serve.speculative import (
    SpeculativeConfig,
    make_draft_prefill,
    make_speculative_loop,
    spec_pair_supported,
)
from repro_torch.train.steps import (
    make_prefill_admit_step,
    make_slot_decode_loop,
)

POLICIES = ("fifo", "spf")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class Request:
    """One generation request."""
    uid: int
    prompt: np.ndarray  # (P,) int32 prompt tokens
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival: float = 0.0  # admission time on the clock ``step(now)`` reads


@dataclasses.dataclass
class _Sequence:
    """In-flight state of an admitted request."""
    req: Request
    slot: int
    pos: int  # current length == write position of the next decode step
    tokens: List[int]


def _device_of(params) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


class ContinuousBatchingEngine:
    """Slot-pool continuous batching over a family's slot-state protocol.

    ``k`` is the macro-step length: decode tokens per dispatch (whole
    speculative blocks in speculative mode).  Larger K amortizes host work
    and syncs over more tokens; admission happens only at block
    boundaries, so K trades admission latency against decode throughput.
    ``policy`` is ``"fifo"`` (arrival order) or ``"spf"`` (length-bucketed
    shortest-prefill-first, ties by arrival).  ``speculative`` -- a
    ``SpeculativeConfig`` (draft cfg, draft params, depth d) -- turns on
    greedy speculative decoding.  ``pool`` is ``"dense"`` or ``"paged"``;
    ``pages`` is the paged arena's page budget (default: as many pages as
    the dense pool holds, ``capacity * nblk``).
    """

    def __init__(self, cfg, params, *, capacity: int = 8,
                 max_len: int = 256, prefill_bucket: int = 16, k: int = 8,
                 policy: str = "fifo", pool: str = "dense",
                 pages: Optional[int] = None, sampling=None,
                 speculative: Optional[SpeculativeConfig] = None,
                 deadline=None, shed_age=None, journal=None, faults=None,
                 mesh=None):
        if pool not in ("dense", "paged"):
            raise ValueError(f"unknown pool kind {pool!r} "
                             "(choose 'dense' or 'paged')")
        unported = {"sampling": sampling is not None,
                    "deadline": deadline is not None,
                    "shed_age": shed_age is not None,
                    "journal": journal is not None,
                    "faults": faults is not None, "mesh": mesh is not None}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"ContinuousBatchingEngine: {', '.join(asked)} not ported to "
                "repro_torch yet (see ROADMAP.md); this engine serves greedy")
        if k < 1:
            raise ValueError(f"macro-step length k must be >= 1 (got {k})")
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r} "
                             f"(choose from {POLICIES})")
        if pool == "paged":
            for c in (cfg, *([] if speculative is None
                             else [speculative.cfg])):
                paged_lib.require_full_layout(c)
        ok, why = serve_supported(cfg)
        if not ok:
            raise NotImplementedError(
                f"continuous batching cannot serve {cfg.name!r}: {why}")
        limit = cfg.max_seq_len
        if cfg.learned_pos:
            limit = min(limit, cfg.learned_pos)
        if max_len > limit:
            raise ValueError(
                f"max_len {max_len} exceeds the model's position range "
                f"{limit}")
        if speculative is not None:
            ok, why = spec_pair_supported(cfg, speculative.cfg,
                                          speculative.d, max_len)
            if not ok:
                raise NotImplementedError(
                    f"speculative serving cannot run this pair: {why}")
            if speculative.cfg.compute_dtype != cfg.compute_dtype:
                # one working type per engine: the draft's catch-up verify
                # reads chunks the target's commit writes, and a silent
                # cast would change what the draft computes
                raise ValueError(
                    f"speculative draft {speculative.cfg.name!r} computes "
                    f"in {speculative.cfg.compute_dtype} but the target "
                    f"{cfg.name!r} in {cfg.compute_dtype}; give both the "
                    "same compute_dtype")
        self.cfg = cfg
        self.params = params
        self.fam = get_family(cfg)
        self.cache_layout = slot_cache_layout(cfg)
        self.device = _device_of(params)
        self.capacity = capacity
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.k = k
        self.policy = policy
        self.waiting: collections.deque[Request] = collections.deque()
        self.active: Dict[int, _Sequence] = {}
        self.finished: Dict[int, np.ndarray] = {}
        self.rejected: Dict[int, str] = {}  # uid -> why submit refused it
        # uid -> terminal outcome: finished / quarantined / rejected
        self.outcomes: Dict[int, str] = {}
        self._seen_uids: set = set()
        self._evict_pending: List[int] = []
        # (host block, host valid, host poison, ready event, [(slot, uid)])
        # of dispatched-but-unread macro steps
        self._inflight: collections.deque = collections.deque()
        self.n_decode_dispatches = 0
        # admission groups prefilled (both pools in speculative mode; the
        # reference counts the draft's prefill as a second one)
        self.n_prefills = 0
        self.n_host_syncs = 0  # blocking device->host reads
        self.n_tokens = 0  # generated tokens (incl. prefill first tokens)
        self.n_quarantined = 0  # NaN/Inf-poisoned slots evicted
        self.speculative = speculative
        self.n_spec_proposed = 0  # draft tokens offered to the target
        self.n_spec_accepted = 0  # draft tokens the target kept
        self.n_spec_fallbacks = 0  # draft faults that tripped plain decode
        self._spec_fallback = False  # draft faulted: plain macro decode

        # paged-mode telemetry (zero on a dense pool)
        self.n_prefix_hits = 0  # admissions served from resident pages
        self.n_prefix_misses = 0  # prefix probes that found no full chain
        self.n_prefix_stalls = 0  # hits deferred on tail-page backpressure
        self.n_pages_allocated = 0  # fresh pages handed out
        self.n_prefix_tail_steps = 0  # masked decode steps of hit waves

        dev = self.device
        self._build_pools(pool, pages)
        # persistent device-resident decode state: (tokens, positions,
        # remaining, eos_ids, done) -- idle slots are done
        self._state = (torch.zeros(capacity, dtype=torch.int32, device=dev),
                       torch.zeros(capacity, dtype=torch.int32, device=dev),
                       torch.zeros(capacity, dtype=torch.int32, device=dev),
                       torch.full((capacity,), -1, dtype=torch.int32,
                                  device=dev),
                       torch.ones(capacity, dtype=torch.bool, device=dev))
        self.free = list(range(capacity))[::-1]  # pop -> slot 0..
        self._loop = make_slot_decode_loop(cfg, k)
        self._prefill = make_prefill_admit_step(cfg)
        if speculative is not None:
            cfg_d = speculative.cfg
            # the plain loop above stays as the degradation ladder's target
            self._spec_loop = make_speculative_loop(cfg, cfg_d,
                                                    speculative.d, k)
            self._draft_prefill = make_draft_prefill(cfg_d)

    def _build_pools(self, pool: str, pages: Optional[int]):
        """The target's (and in speculative mode the draft's) slot pool,
        dense or paged.  Paged pools share ONE page-id space: page ``p``
        is row ``p`` of every pool's arenas, a request allocates its
        worst-case page count once (a reference in each pool's namespace)
        and every pool consumes the leading slice, so one ``pages`` budget
        is real shared memory that draft and target trade freely."""
        cfgs = [self.cfg]
        if self.speculative is not None:
            cfgs.append(self.speculative.cfg)
        fams = [get_family(c) for c in cfgs]
        cap, max_len, dev = self.capacity, self.max_len, self.device
        metas = [None] * len(cfgs)
        reasons = []
        if pool == "paged":
            for i, (f, c) in enumerate(zip(fams, cfgs)):
                metas[i] = paged_lib.pool_meta(
                    c, f.init_cache(c, cap, max_len, device="meta"))
                if metas[i] is None:
                    role = "target" if i == 0 else "draft"
                    reasons.append(f"{role}: "
                                   f"{paged_lib.pool_fallback_reason(c)}")
        self.pool_fallback_reason = "; ".join(reasons) or None
        paged_idx = [i for i, m in enumerate(metas) if m is not None]
        self.pages_budget = None
        n_pages = None
        if paged_idx:
            n_pages = int(pages) if pages else max(metas[i].n_pages
                                                   for i in paged_idx)
            self.pages_budget = n_pages
        pools = []
        for i, (f, c) in enumerate(zip(fams, cfgs)):
            if metas[i] is not None:
                p, metas[i] = paged_lib.build_paged_pool(
                    f, c, cap, max_len, n_pages=n_pages, device=dev)
            else:
                p = f.init_cache(c, cap, max_len, device=dev)
            pools.append(p)
        self.pool = pools[0]
        self.pool_d = pools[1] if len(pools) > 1 else None
        self._metas = tuple(metas)
        self._paged = bool(paged_idx)
        self.pool_kind = "paged" if self._paged else "dense"
        # pool index -> refcount namespace in the shared allocator
        self._ns_of = {pi: j for j, pi in enumerate(paged_idx)}
        self._alloc = paged_lib.PageAllocator(
            metas[paged_idx[0]], namespaces=len(paged_idx)) \
            if paged_idx else None
        # slot -> the page ids its request holds (one list: every paged
        # pool consumes its leading slice of the same ids)
        self._slot_pages: Dict[int, list] = {}
        # pages released to zero outside an eviction (a stalled hit's
        # unpin, a flushed registry), zeroed with the next eviction
        self._zero_pending: List[int] = []
        # prefix sharing: full-KV target pages are addressed by absolute
        # position; off under speculation and for every family but the
        # transformer (a recurrent state has no pages to share), as in the
        # reference
        self._prefix_ok = (metas[0] is not None
                           and self.speculative is None
                           and self.cfg.family == "transformer"
                           and metas[0].page > 0)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target accepted (speculative
        mode; 0.0 before any speculative block was read back)."""
        return self.n_spec_accepted / max(self.n_spec_proposed, 1)

    @property
    def pages_in_use(self) -> int:
        """Live (refcounted) pages of the shared arena (0 when dense)."""
        return self._alloc.pages_in_use() if self._alloc is not None else 0

    @property
    def pages_highwater(self) -> int:
        """Peak live pages of the shared arena so far (0 when dense)."""
        return self._alloc.highwater if self._alloc is not None else 0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prefix probes served from resident pages."""
        probes = self.n_prefix_hits + self.n_prefix_misses
        return self.n_prefix_hits / max(probes, 1)

    # ------------------------------------------------------------- admission
    def _reject(self, uid: int, why: str):
        """Graceful rejection: record and keep serving.  The uid is NOT
        marked seen -- a corrected resubmission is fine."""
        self.rejected[uid] = why
        self.outcomes[uid] = "rejected"

    def _invalid_reason(self, req: Request) -> Optional[str]:
        """Every malformed-request class, in one place: a bad request is
        recorded, never raised, so it cannot kill in-flight sequences."""
        P = len(req.prompt)
        if req.max_new_tokens < 1:
            return ("max_new_tokens must be >= 1 "
                    "(prefill always emits the first token)")
        if P < 1:
            return "empty prompt"
        if req.eos_id is not None and not (
                0 <= req.eos_id < self.cfg.vocab_size):
            return (f"eos_id {req.eos_id} outside the vocabulary "
                    f"[0, {self.cfg.vocab_size})")
        toks = np.asarray(req.prompt)
        if int(toks.min()) < 0 or int(toks.max()) >= self.cfg.vocab_size:
            return (f"prompt tokens outside the vocabulary "
                    f"[0, {self.cfg.vocab_size})")
        if P + req.max_new_tokens > self.max_len:
            return (f"prompt {P} + {req.max_new_tokens} new tokens "
                    f"exceeds max_len {self.max_len}")
        if self._alloc is not None:
            need = max(paged_lib.pages_needed(P, req.max_new_tokens, m)
                       for m in self._metas if m is not None)
            if need > self._alloc.meta.n_pages:
                # no eviction wave can ever make room for it: queued, it
                # would bounce off admission forever
                return (f"needs {need} pages but the arena holds only "
                        f"{self._alloc.meta.n_pages} (raise --pages or "
                        f"shrink the request)")
        return None

    def submit(self, req: Request):
        if req.uid in self._seen_uids:
            # a duplicate uid is a caller bug, not a malformed request
            raise ValueError(f"request uid {req.uid} already submitted")
        why = self._invalid_reason(req)
        if why is not None:
            self._reject(req.uid, f"request {req.uid}: {why}")
            return
        self._seen_uids.add(req.uid)
        self.waiting.append(req)

    def _bucketed(self, n: int) -> int:
        b = self.prefill_bucket
        return min(-(-n // b) * b, self.max_len)

    def _select_admissions(self, now: Optional[float]) -> List[Request]:
        """Pick the arrived requests to admit into the free slots: FIFO in
        submission order, or ``spf`` by bucketed prefill length (ties by
        submission order).  Never skips an arrived request when a slot is
        free for it."""
        nfree = len(self.free)
        if nfree == 0 or not self.waiting:
            return []
        if now is None and self.policy == "fifo":
            return [self.waiting.popleft()
                    for _ in range(min(nfree, len(self.waiting)))]
        items = list(self.waiting)
        arrived = [i for i, r in enumerate(items)
                   if now is None or r.arrival <= now]
        if self.policy == "spf":
            arrived.sort(key=lambda i: (
                self._bucketed(len(items[i].prompt)), i))
        take = arrived[:nfree]
        if not take:
            return []
        taken = set(take)
        self.waiting = collections.deque(
            r for i, r in enumerate(items) if i not in taken)
        return [items[i] for i in take]

    def _alloc_request(self, req: Request):
        """Reserve shared-arena pages for one request.

        Returns an admission record, or None on backpressure (nothing is
        held: the alloc is all-or-nothing).  A request allocates its
        worst-case page count once, with a reference in every paged pool's
        namespace.  With prefix sharing on, the target's registry is
        probed first: every full page strictly before the prompt's last
        token must resolve (the whole chain or nothing); a hit increfs
        the resident pages, allocates only its private tail and takes the
        no-prefill admission path.
        """
        P = len(req.prompt)
        alloc = self._alloc
        ns_all = tuple(self._ns_of.values())
        info = {"hit": False, "share": 0, "digests": None, "pids": None}
        if self._prefix_ok:
            meta = self._metas[0]
            digests = paged_lib.prefix_digests(req.prompt, meta.page)
            info["digests"] = digests
            share = (P - 1) // meta.page  # >= 1 private tail token stays
            resident = alloc.lookup(digests[:share]) if share > 0 else None
            if resident is not None:
                # pin the resident pages BEFORE the tail alloc: alloc()
                # reclaims zero-ref retained pages when the free list runs
                # dry, which could hand back the very pages just looked
                # up as this slot's private tail
                alloc.incref(resident)
                total = paged_lib.pages_needed(P, req.max_new_tokens, meta)
                tail = alloc.alloc(total - share, ns=ns_all)
                if tail is None:
                    # tail backpressure, not a registry miss: unpin and
                    # wait for the next eviction wave
                    self._zero_pending.extend(alloc.release(resident))
                    self.n_prefix_stalls += 1
                    return None
                info.update(hit=True, share=share,
                            pids=list(resident) + tail)
                self.n_prefix_hits += 1
                self.n_pages_allocated += len(tail)
                return info
            if share > 0:
                self.n_prefix_misses += 1
        need = max(paged_lib.pages_needed(P, req.max_new_tokens, m)
                   for m in self._metas if m is not None)
        pids = alloc.alloc(need, ns=ns_all)
        if pids is None:
            return None
        info["pids"] = pids
        self.n_pages_allocated += len(pids)
        return info

    def _admit_batch(self, now: Optional[float]):
        """Admit every arrived request a free slot can take: ONE prefill
        dispatch, ONE pool/state copy and ONE host sync per prefill-bucket
        group.  A paged pool puts a page-allocation pass in front
        (all-or-nothing per request: the first request that cannot get its
        pages returns itself and everything grabbed after it to the FRONT
        of the queue, in order) and sends prefix hits to the no-prefill
        path, one host sync for all of them."""
        grabbed = self._select_admissions(now)
        if not grabbed:
            return
        if self._paged:
            pairs = []
            for i, r in enumerate(grabbed):
                info = self._alloc_request(r)
                if info is None:
                    # page backpressure: wait for the next eviction wave
                    self.waiting.extendleft(reversed(grabbed[i:]))
                    break
                pairs.append((r, info))
        else:
            pairs = [(r, None) for r in grabbed]
        groups: Dict[int, list] = {}
        for r, a in pairs:
            if a is None or not a["hit"]:
                groups.setdefault(self._bucketed(len(r.prompt)),
                                  []).append((r, a))
        for bucket, group in sorted(groups.items()):
            self._admit_group(bucket, group)
        hits = [(r, a) for r, a in pairs if a is not None and a["hit"]]
        if hits:
            self._admit_hits(hits)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        plain ``.to("cuda")`` of pageable memory synchronises the stream,
        which would make every admission or eviction wait for the macro
        step still in flight.  Pinned memory copies asynchronously."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _take_slots(self, pairs):
        """Pop a free slot for each admitted (request, record) pair and
        book its pages; returns the slots and each pool's (n, nblk)
        block-table rows (None for a dense pool), unallocated blocks at
        the sentinel."""
        n = len(pairs)
        slots = np.zeros((n,), np.int64)
        bt_rows = [None if m is None else
                   np.full((n, m.nblk), m.sentinel, np.int32)
                   for m in self._metas]
        for j, (_, a) in enumerate(pairs):
            slots[j] = self.free.pop()
            if a is not None:
                pids = a["pids"]
                self._slot_pages[int(slots[j])] = pids
                for rows in filter(lambda b: b is not None, bt_rows):
                    cnt = min(len(pids), rows.shape[1])
                    rows[j, :cnt] = pids[:cnt]
        return slots, bt_rows

    def _scatter_rows(self, pool, rows, idx, n, bt_rows, meta):
        """Copy the first ``n`` prefilled scratch rows into their slots:
        in place on a dense pool, through the block tables on a paged
        one (padding rows target no slot and are simply not copied)."""
        real = {key: {name: leaf[:, :n] for name, leaf in grp.items()}
                for key, grp in rows.items()}
        if meta is None:
            for key, grp in pool.items():
                for name, leaf in grp.items():
                    leaf.index_copy_(1, idx, real[key][name])
        else:
            paged_lib.admit_scatter(pool, real, idx,
                                    self._to_device(bt_rows), meta)

    def _set_state(self, idx, first_n, plens, rem0, eos_new):
        """Write the admitted rows' decode state in place."""
        plens_d = self._to_device(plens)
        rem0_d = self._to_device(rem0)
        eos_d = self._to_device(eos_new)
        tokens, positions, remaining, eos, done = self._state
        tokens.index_copy_(0, idx, first_n)
        positions.index_copy_(0, idx, plens_d)
        remaining.index_copy_(0, idx, rem0_d)
        eos.index_copy_(0, idx, eos_d)
        # a request can finish at its very first (prefill) token
        done.index_copy_(0, idx, (first_n == eos_d) | (rem0_d <= 0))

    def _admit_group(self, bucket: int, group):
        """Batched-prefill admission of ``group``'s (request, page record)
        pairs: dense pools, and paged requests whose prefix missed."""
        dev = self.device
        n = len(group)
        npad = _pow2(n)  # bounds the distinct (group size, bucket) shapes
        padded = np.zeros((npad, bucket), np.int32)
        plens = np.ones((npad,), np.int32)
        for j, (r, _) in enumerate(group):
            plens[j] = len(r.prompt)
            padded[j, :plens[j]] = r.prompt
        slots, bt_rows = self._take_slots(group)
        # the scratch rows get full pool-length caches so every admission
        # prefill attends over the same cache length as the pool
        rows = self.fam.init_cache(self.cfg, npad, self.max_len, device=dev)
        plens_d = self._to_device(plens)
        padded_d = self._to_device(padded)
        first, rows = self._prefill(self.params, padded_d, plens_d, rows)
        idx = self._to_device(slots)
        self._scatter_rows(self.pool, rows, idx, n, bt_rows[0],
                           self._metas[0])
        if self.speculative is not None:
            # the draft pool admits the SAME prompt rows: its per-row state
            # after the real prompt; the first token is the target's
            cfg_d = self.speculative.cfg
            rows_d = get_family(cfg_d).init_cache(cfg_d, npad, self.max_len,
                                                  device=dev)
            rows_d = self._draft_prefill(self.speculative.params, padded_d,
                                         plens_d, rows_d)
            self._scatter_rows(self.pool_d, rows_d, idx, n, bt_rows[1],
                               self._metas[1])
            self.n_prefills += 1  # the draft's prefill counts, as in JAX
        first_n = first[:n]
        self._set_state(idx, first_n, plens[:n], *self._budgets(group))
        self.n_prefills += 1
        first_host = first_n.cpu().numpy()
        self.n_host_syncs += 1
        for j, (r, a) in enumerate(group):
            seq = _Sequence(r, int(slots[j]), pos=int(plens[j]),
                            tokens=[int(first_host[j])])
            self.active[seq.slot] = seq
            self.n_tokens += 1
            if a is not None and a["digests"]:
                # the pages the prompt covers in full now hold its
                # prefill-built KV: make them shareable (tail pages built
                # by the hit path's decode steps are never registered)
                reg = len(r.prompt) // self._metas[0].page
                if reg:
                    self._alloc.register(a["digests"][:reg], a["pids"][:reg])
            self._finish_if_done(seq, seq.tokens[-1])

    @staticmethod
    def _budgets(pairs):
        """(remaining after the first token, eos id or -1) per request."""
        rem0 = np.array([r.max_new_tokens - 1 for r, _ in pairs], np.int32)
        eos = np.array([-1 if r.eos_id is None else r.eos_id
                        for r, _ in pairs], np.int32)
        return rem0, eos

    def _admit_hits(self, pairs):
        """No-prefill admission of prefix hits: point the slots' leading
        block-table entries at the resident shared pages, then run only
        the private tail tokens (at most one page of them) through masked
        decode steps over the whole pool -- rows outside the wave are
        ``done``, so their writes go to the scratch page and nothing of
        theirs changes.  The reference scans a full page of steps; steps
        past the longest tail change nothing, so the loop stops there.
        One host sync reads the first tokens."""
        meta = self._metas[0]
        cap, dev = self.capacity, self.device
        slots, bt_rows = self._take_slots(pairs)
        wave = np.zeros((cap,), bool)
        tail_len = np.zeros((cap,), np.int32)
        pos0 = np.zeros((cap,), np.int32)
        tail_tokens = np.zeros((cap, meta.page), np.int32)
        plens = np.zeros((len(pairs),), np.int32)
        for j, (r, a) in enumerate(pairs):
            slot = slots[j]
            p0 = a["share"] * meta.page
            tail = np.asarray(r.prompt[p0:], np.int32)
            wave[slot] = True
            pos0[slot] = p0
            tail_len[slot] = len(tail)
            tail_tokens[slot, :len(tail)] = tail
            plens[j] = len(r.prompt)
        idx = self._to_device(slots)
        paged_lib.set_block_tables(self.pool, idx,
                                   self._to_device(bt_rows[0]), meta)
        wave_d, tl_d, p0_d, toks_d = (self._to_device(a) for a in (
            wave, tail_len, pos0, tail_tokens))
        first = torch.zeros(cap, dtype=torch.int32, device=dev)
        for j in range(int(tail_len.max())):
            live = wave_d & (j < tl_d)
            logits, self.pool = self.fam.decode_step_slots(
                self.params, toks_d[:, j].contiguous(), p0_d + j, self.pool,
                self.cfg, done=~live)
            nxt = logits.argmax(-1).to(torch.int32)
            first = torch.where(live & (tl_d == j + 1), nxt, first)
            self.n_prefix_tail_steps += 1
        first_n = first[idx]
        self._set_state(idx, first_n, plens, *self._budgets(pairs))
        first_host = first_n.cpu().numpy()
        self.n_host_syncs += 1
        for j, (r, _) in enumerate(pairs):
            seq = _Sequence(r, int(slots[j]), pos=int(plens[j]),
                            tokens=[int(first_host[j])])
            self.active[seq.slot] = seq
            self.n_tokens += 1
            self._finish_if_done(seq, seq.tokens[-1])

    # ------------------------------------------------------------- lifecycle
    def _finish_if_done(self, seq: _Sequence, last_token: int):
        """Host-side stopping rule -- the mirror of the on-device rule (the
        device marks the row done at the same token)."""
        if (len(seq.tokens) >= seq.req.max_new_tokens
                or (seq.req.eos_id is not None
                    and last_token == seq.req.eos_id)):
            self._retire(seq, "finished")

    def _retire(self, seq: _Sequence, outcome: str):
        self.finished[seq.req.uid] = np.asarray(seq.tokens, np.int32)
        self.outcomes[seq.req.uid] = outcome
        del self.active[seq.slot]
        # the slot re-enters ``free`` only once its eviction is applied
        # (_flush_evictions), so a same-wave admission cannot be wiped by
        # the pending zeroing
        self._evict_pending.append(seq.slot)

    def _flush_evictions(self):
        """Zero retired slots' pool rows and reset their decode state in
        place.  Admission overwrites a whole row anyway; zeroing keeps a
        retired request's KV from outliving it in device memory, and idle
        slots' no-op steps then derive from token 0.

        A paged pool releases the retired slots' pages here (one reference
        per namespace) and zeroes, in every paged pool, only the pages
        whose count reaches zero; prefix-registered pages are retained
        with their bytes (they are the cached value), and the slots' block
        tables go back to the sentinel."""
        if not self._evict_pending and not self._zero_pending:
            return
        zero = list(self._zero_pending)
        self._zero_pending.clear()
        for slot in self._evict_pending:
            pids = self._slot_pages.pop(slot, None)
            if pids:
                # a page crosses GLOBAL zero during exactly one of these
                # releases and is then zeroed in every paged pool
                for ns in self._ns_of.values():
                    zero.extend(self._alloc.release(pids, ns=ns))
        idx = self._to_device(np.asarray(self._evict_pending, np.int64))
        for pool, meta in zip((self.pool, self.pool_d), self._metas):
            if meta is not None:
                paged_lib.evict_clear(pool, idx, self._to_device(
                    np.asarray(zero, np.int64)), meta)
            elif pool is not None:
                for grp in pool.values():
                    for leaf in grp.values():
                        leaf.index_fill_(1, idx, 0)
        tokens, positions, remaining, eos, done = self._state
        tokens.index_fill_(0, idx, 0)
        positions.index_fill_(0, idx, 0)
        remaining.index_fill_(0, idx, 0)
        eos.index_fill_(0, idx, -1)
        done.index_fill_(0, idx, True)
        self.free.extend(self._evict_pending)
        self._evict_pending.clear()

    def _quarantine(self, seq: _Sequence):
        """Evict a slot whose logits went non-finite.  On a paged pool its
        pages may have fed resident prefixes, so the registry is flushed
        and prefix sharing stops (the reference's further rung, full
        reservation for every later admission, is not ported)."""
        self.n_quarantined += 1
        self._retire(seq, "quarantined")
        if self._alloc is not None and self._prefix_ok:
            self._zero_pending.extend(self._alloc.flush_registry())
            self._prefix_ok = False

    # ------------------------------------------------------------- step loop
    def _dispatch(self):
        """Enqueue one macro step (K decode steps, or K whole speculative
        draft→verify→commit blocks) and its readback, with no host sync."""
        tokens, positions, remaining, eos_ids, done = self._state
        if self.speculative is not None and not self._spec_fallback:
            (block, valid, poison, dbad, tokens, positions, remaining, done,
             self.pool, self.pool_d, n_prop, n_acc) = self._spec_loop(
                self.params, self.speculative.params, tokens, positions,
                remaining, eos_ids, done, self.pool, self.pool_d)
            # acceptance telemetry and the draft-fault flag in one tensor
            stats = torch.stack([n_prop, n_acc, dbad.long()])
        else:
            # a speculative engine whose draft misbehaved keeps serving
            # through the plain macro loop on its TARGET pool
            (block, valid, poison, tokens, positions, remaining, done,
             self.pool) = self._loop(self.params, tokens, positions,
                                     remaining, eos_ids, done, self.pool)
            stats = None
        self._state = (tokens, positions, remaining, eos_ids, done)
        host, ready = (block, valid, poison, stats), None
        if self.device.type == "cuda":
            host = tuple(None if t is None else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record()
        self.n_decode_dispatches += 1
        live = [(slot, seq.req.uid) for slot, seq in self.active.items()]
        self._inflight.append((*host, ready, live))

    def _process(self, item):
        """Wait for one macro step's token block (the single host sync per
        dispatch) and advance the host-side sequence records; the
        speculative telemetry rides the same readback."""
        block, valid, poison, stats, ready, live = item
        if ready is not None:
            ready.synchronize()
        block, valid, poison = block.numpy(), valid.numpy(), poison.numpy()
        self.n_host_syncs += 1
        if stats is not None:
            n_prop, n_acc, dbad = (int(x) for x in stats.numpy())
            self.n_spec_proposed += n_prop
            self.n_spec_accepted += n_acc
            if dbad and not self._spec_fallback:
                # degradation ladder: draft logits went non-finite; every
                # request keeps being served by the plain target-only loop
                self._spec_fallback = True
                self.n_spec_fallbacks += 1
        for slot, uid in live:
            seq = self.active.get(slot)
            if seq is None or seq.req.uid != uid:
                # retired (and maybe re-admitted) while this block was in
                # flight; its rows were device-done, so nothing is valid
                continue
            vm = valid[:, slot]
            nv = int(vm.sum())
            if nv:
                seq.pos += nv
                seq.tokens.extend(int(t) for t in block[:, slot][vm])
                self.n_tokens += nv
                self._finish_if_done(seq, seq.tokens[-1])
            if poison[slot] and self.active.get(slot) is seq:
                # the row froze itself at the non-finite step; nothing
                # from that step was committed
                self._quarantine(seq)

    def step(self, now: Optional[float] = None):
        """One synchronous engine iteration: evict, admit arrived requests
        into free slots, run one macro step, and read it back."""
        self._flush_evictions()
        self._admit_batch(now)
        if self.active:
            self._dispatch()
        while self._inflight:
            self._process(self._inflight.popleft())

    def run(self, requests=None):
        """Serve until every submitted request finishes, double-buffering
        readback: block N+1 is enqueued before the host waits on block N,
        so admissions chain onto the latest enqueued state (a queued
        request waits at most one extra block).  Returns {uid: generated
        tokens} for the requests that finished during THIS call."""
        already = set(self.finished)
        for r in requests or ():
            self.submit(r)
        while self.waiting or self.active or self._inflight:
            self._flush_evictions()
            self._admit_batch(None)
            if self.active:
                self._dispatch()
            # wait on the OLDEST block only once a newer one is enqueued
            # (or nothing is left to dispatch)
            if len(self._inflight) >= (2 if self.active else 1):
                self._process(self._inflight.popleft())
        self._flush_evictions()
        return {uid: toks for uid, toks in self.finished.items()
                if uid not in already}
