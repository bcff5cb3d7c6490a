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
                         (``step()`` is the synchronous single iteration).

Everything runs on the device the params live on.  Buffers the reference
package donates to XLA are updated in place here (``index_copy_`` /
``index_fill_`` on the pool and the decode state).  Padding rows of an
admission group target no slot: the reference scatters them to the
out-of-range index ``capacity``, which XLA drops and PyTorch indexing
would refuse, so only the first ``n`` rows are copied.

Greedy tokens are the sequential ``generate()`` tokens for every request,
for any interleaving and any K, up to float near-ties between the two
routes' arithmetic.  Paged pools, speculation, sampling, deadlines,
faults, the journal, live upgrade and meshes are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import get_family, serve_supported, slot_cache_layout
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

    ``k`` is the macro-step length: decode tokens per dispatch.  Larger K
    amortizes host work and syncs over more tokens; admission happens only
    at block boundaries, so K trades admission latency against decode
    throughput.  ``policy`` is ``"fifo"`` (arrival order) or ``"spf"``
    (length-bucketed shortest-prefill-first, ties by arrival).
    """

    def __init__(self, cfg, params, *, capacity: int = 8,
                 max_len: int = 256, prefill_bucket: int = 16, k: int = 8,
                 policy: str = "fifo", pool: str = "dense", sampling=None,
                 speculative=None, deadline=None, shed_age=None,
                 journal=None, faults=None, mesh=None):
        if pool not in ("dense", "paged"):
            raise ValueError(f"unknown pool kind {pool!r} "
                             "(choose 'dense' or 'paged')")
        unported = {"pool='paged'": pool == "paged",
                    "sampling": sampling is not None,
                    "speculative": speculative is not None,
                    "deadline": deadline is not None,
                    "shed_age": shed_age is not None,
                    "journal": journal is not None,
                    "faults": faults is not None, "mesh": mesh is not None}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"ContinuousBatchingEngine: {', '.join(asked)} not ported to "
                "repro_torch yet (see ROADMAP.md); this engine serves greedy "
                "on the dense pool")
        if k < 1:
            raise ValueError(f"macro-step length k must be >= 1 (got {k})")
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r} "
                             f"(choose from {POLICIES})")
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
        self.n_prefills = 0  # admission-batch prefill dispatches
        self.n_host_syncs = 0  # blocking device->host reads
        self.n_tokens = 0  # generated tokens (incl. prefill first tokens)
        self.n_quarantined = 0  # NaN/Inf-poisoned slots evicted

        dev = self.device
        self.pool = self.fam.init_cache(cfg, capacity, max_len, device=dev)
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

    def _admit_batch(self, now: Optional[float]):
        """Admit every arrived request a free slot can take: ONE prefill
        dispatch, ONE pool/state copy and ONE host sync per prefill-bucket
        group."""
        grabbed = self._select_admissions(now)
        groups: Dict[int, list] = {}
        for r in grabbed:
            groups.setdefault(self._bucketed(len(r.prompt)), []).append(r)
        for bucket, group in sorted(groups.items()):
            self._admit_group(bucket, group)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        plain ``.to("cuda")`` of pageable memory synchronises the stream,
        which would make every admission or eviction wait for the macro
        step still in flight.  Pinned memory copies asynchronously."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _admit_group(self, bucket: int, group: List[Request]):
        dev = self.device
        n = len(group)
        npad = _pow2(n)  # bounds the distinct (group size, bucket) shapes
        padded = np.zeros((npad, bucket), np.int32)
        plens = np.ones((npad,), np.int32)
        rem0 = np.zeros((npad,), np.int32)
        eos_new = np.full((npad,), -1, np.int32)
        slots = np.zeros((n,), np.int64)
        for j, r in enumerate(group):
            plens[j] = len(r.prompt)
            padded[j, :plens[j]] = r.prompt
            rem0[j] = r.max_new_tokens - 1
            eos_new[j] = -1 if r.eos_id is None else r.eos_id
            slots[j] = self.free.pop()
        # the scratch rows get full pool-length caches so every admission
        # prefill attends over the same cache length as the pool
        rows = self.fam.init_cache(self.cfg, npad, self.max_len, device=dev)
        plens_d = self._to_device(plens)
        first, rows = self._prefill(self.params, self._to_device(padded),
                                    plens_d, rows)
        # copy the n real rows into their slots in place; padding rows
        # (n..npad) target no slot and are simply not copied
        idx = self._to_device(slots)
        for name, leaf in self.pool["dense"].items():
            leaf.index_copy_(1, idx, rows["dense"][name][:, :n])
        first_n = first[:n]
        rem0_d = self._to_device(rem0[:n])
        eos_d = self._to_device(eos_new[:n])
        tokens, positions, remaining, eos, done = self._state
        tokens.index_copy_(0, idx, first_n)
        positions.index_copy_(0, idx, plens_d[:n])
        remaining.index_copy_(0, idx, rem0_d)
        eos.index_copy_(0, idx, eos_d)
        # a request can finish at its very first (prefill) token
        done.index_copy_(0, idx, (first_n == eos_d) | (rem0_d <= 0))
        self.n_prefills += 1
        first_host = first_n.cpu().numpy()
        self.n_host_syncs += 1
        for j, r in enumerate(group):
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
        slots' no-op steps then derive from token 0."""
        if not self._evict_pending:
            return
        idx = self._to_device(np.asarray(self._evict_pending, np.int64))
        for leaf in self.pool["dense"].values():
            leaf.index_fill_(1, idx, 0)
        tokens, positions, remaining, eos, done = self._state
        tokens.index_fill_(0, idx, 0)
        positions.index_fill_(0, idx, 0)
        remaining.index_fill_(0, idx, 0)
        eos.index_fill_(0, idx, -1)
        done.index_fill_(0, idx, True)
        self.free.extend(self._evict_pending)
        self._evict_pending.clear()

    # ------------------------------------------------------------- step loop
    def _dispatch(self):
        """Enqueue one macro step (K decode steps) and its readback, with
        no host sync."""
        tokens, positions, remaining, eos_ids, done = self._state
        (block, valid, poison, tokens, positions, remaining, done,
         self.pool) = self._loop(self.params, tokens, positions, remaining,
                                 eos_ids, done, self.pool)
        self._state = (tokens, positions, remaining, eos_ids, done)
        if self.device.type == "cuda":
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in (block, valid, poison))
            for h, t in zip(host, (block, valid, poison)):
                h.copy_(t, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = (block, valid, poison), None
        self.n_decode_dispatches += 1
        live = [(slot, seq.req.uid) for slot, seq in self.active.items()]
        self._inflight.append((*host, ready, live))

    def _process(self, item):
        """Wait for one macro step's token block (the single host sync per
        dispatch) and advance the host-side sequence records."""
        block, valid, poison, ready, live = item
        if ready is not None:
            ready.synchronize()
        block, valid, poison = block.numpy(), valid.numpy(), poison.numpy()
        self.n_host_syncs += 1
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
                self.n_quarantined += 1
                self._retire(seq, "quarantined")

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
