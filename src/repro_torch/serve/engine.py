"""Continuous-batching serve engine with on-device macro-step decode.

The engine serves a stream of requests through a fixed-capacity slot
pool, on the dense pool layout of the reference package:

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
                         prefill; a windowed (ring) target instead copies
                         its last intact full prompt pages into
                         registry-only pages at admission, and a hit
                         rebuilds its private ring from them before the
                         tail steps; ``pages`` sets the arena's page
                         budget;
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
                         and budget; prefix sharing stays off;
  * sampling          -- a non-greedy ``SamplingParams`` threads per-slot
                         threefry chains (``serve/sampling.py``) through
                         admission, prefix hits and the decode loops:
                         roots come from (seed, uid) on the device,
                         admission scatters them, eviction zeroes them,
                         and no draw reads anything back to the host
                         (speculative mode uses rejection sampling).

Everything runs on the device the params live on.  Buffers the reference
package donates to XLA are updated in place here (``index_copy_`` /
``index_fill_`` on the pool and the decode state).  Padding rows of an
admission group target no slot: the reference scatters them to the
out-of-range index ``capacity``, which XLA drops and PyTorch indexing
would refuse, so only the first ``n`` rows are copied.

The engine serves any family of the slot-state protocol: the transformer
(full KV, or a ring-window KV cache with a window), griffin (recurrent
state, dense per slot, beside ring-window local-attention caches) and
xlstm (mLSTM/sLSTM recurrent state, dense per slot); rings page on a
paged pool, and so do xlstm's conv tails, one page a slot.  Prefix
sharing is the transformer's alone.  Greedy tokens are
the sequential ``generate()`` tokens for every request, for any
interleaving, any K, any speculation depth and either pool, up to float
near-ties between the routes' arithmetic; sampled tokens are a function
of (seed, uid, prompt) alone.

The runtime layer: a ``serve.recovery.RequestJournal`` (``journal=``)
records every submit, committed token, finish and rejection, flushed only
at the host syncs the engine already pays (the admission readback and the
block readback), so journaling adds none.  A request with ``n_committed``
is a RESUME: its prompt is the original prompt followed by the tokens it
had committed, prefill re-derives the next token (a sampled one advances
its chain past the committed run first), and its budget counts the run.
A ``serve.upgrade.UpgradeManager`` attached as ``upgrade`` hot-swaps a
grown model in at a block boundary: the engine quiesces, turns every
mid-flight sequence into a resume, rebuilds everything derived from the
model (``_configure``) and re-admits the resumes ahead of the queue.
Telemetry counts per drain window (``drain()``; ``lifetime_totals()``
keeps the view since construction).

The fault layer: ``deadline`` (an engine-wide TTL in seconds, overridden
per request by ``Request.deadline``) expires requests at step boundaries
-- an active one keeps its partial tokens, a queued one gets an empty
output -- and ``shed_age`` sheds requests queued longer than it (told why
in ``rejected``, their uids free again).  A slot whose logits go
non-finite is quarantined; on a paged pool that also degrades the arena:
the prefix registry is flushed and every later admission reserves its
full block table.  A ``serve.faults.FaultPlan`` (``faults=``) injects
NaN, oom, slow, hang, malformed and crash faults at dispatch boundaries.
Each fault is reported by counters and outcomes, never hidden.  Every
clock read and sleep goes through ``serve.faults.monotonic`` / ``sleep``.
Meshes are not ported (the distributed slice).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import get_family, serve_supported, slot_cache_layout
from repro_torch.serve import faults as faults_lib
from repro_torch.serve import paged as paged_lib
from repro_torch.serve import sampling as sampling_lib
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

# Telemetry that accumulates per drain window, as in the reference:
# ``drain()`` folds these into ``engine.lifetime`` and zeroes them, so a
# long-lived server's rates (acceptance, tok/s, hit rate) describe the
# current window.
_WINDOW_COUNTERS = (
    "n_decode_dispatches", "n_decode_steps", "n_prefills", "n_host_syncs",
    "n_tokens", "n_spec_proposed", "n_spec_accepted", "n_admitted",
    "n_prefix_hits", "n_prefix_misses", "n_prefix_stalls",
    "n_pages_allocated", "n_expired", "n_quarantined", "n_shed",
    "n_spec_fallbacks", "n_faults_injected", "n_degraded_admissions",
    "n_held_for_upgrade",
)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class Request:
    """One generation request.

    ``n_committed`` marks the last N prompt tokens as previously COMMITTED
    generated tokens (the resume contract of the journal and the live
    upgrade): the prompt is the original prompt followed by the committed
    run, and the budget counts the run against ``max_new_tokens``.
    ``deadline`` is a per-request TTL in seconds (it overrides the
    engine's ``deadline``) and round-trips through the journal."""
    uid: int
    prompt: np.ndarray  # (P,) int32 prompt tokens
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival: float = 0.0  # admission time on the clock ``step(now)`` reads
    deadline: Optional[float] = None
    n_committed: int = 0  # resume: committed suffix of ``prompt``


@dataclasses.dataclass
class _Sequence:
    """In-flight state of an admitted request."""
    req: Request
    slot: int
    pos: int  # current length == write position of the next decode step
    tokens: List[int]
    t_first: float = 0.0  # wall time of the first token (orders resumes)
    t_done: float = 0.0  # wall time of retirement


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
    shortest-prefill-first, ties by arrival).  ``sampling`` -- a
    ``SamplingParams`` -- draws instead of taking the argmax (a greedy one,
    temperature 0, is the greedy engine).  ``speculative`` -- a
    ``SpeculativeConfig`` (draft cfg, draft params, depth d) -- turns on
    speculative decoding.  ``pool`` is ``"dense"`` or ``"paged"``;
    ``pages`` is the paged arena's page budget (default: as many pages as
    the dense pool holds, ``capacity * nblk``).  ``deadline`` and
    ``shed_age`` (seconds) turn on the deadline watchdog and queue-age load
    shedding; ``faults`` attaches a ``serve.faults.FaultPlan``.
    """

    def __init__(self, cfg, params, *, capacity: int = 8,
                 max_len: int = 256, prefill_bucket: int = 16, k: int = 8,
                 policy: str = "fifo", pool: str = "dense",
                 pages: Optional[int] = None,
                 sampling: Optional[sampling_lib.SamplingParams] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 deadline=None, shed_age=None, journal=None, faults=None,
                 mesh=None):
        if pool not in ("dense", "paged"):
            raise ValueError(f"unknown pool kind {pool!r} "
                             "(choose 'dense' or 'paged')")
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousBatchingEngine: mesh not ported to repro_torch "
                "yet (sharded serving is the distributed slice, see "
                "ROADMAP.md)")
        if k < 1:
            raise ValueError(f"macro-step length k must be >= 1 (got {k})")
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r} "
                             f"(choose from {POLICIES})")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 (got {deadline})")
        if shed_age is not None and shed_age <= 0:
            raise ValueError(f"shed_age must be > 0 (got {shed_age})")
        self.capacity = capacity
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.k = k
        self.policy = policy
        self.sampling = None if sampling_lib.is_greedy(sampling) \
            else sampling
        self.deadline = deadline  # engine-wide TTL (seconds); None = off
        self.shed_age = shed_age  # queue-age load-shed threshold
        self.journal = journal  # serve.recovery.RequestJournal or None
        self.faults = faults  # serve.faults.FaultPlan or None
        self._pool_arg = pool  # requested pool kind (re-applied on a swap)
        self.pages_arg = pages  # requested page budget (snapshot field)
        # host-side request bookkeeping: owned here and never rebuilt by
        # _configure -- a live upgrade replaces the model under the
        # traffic, not the traffic under the model
        self.waiting: collections.deque[Request] = collections.deque()
        self.active: Dict[int, _Sequence] = {}
        self.finished: Dict[int, np.ndarray] = {}
        self.retired: List[_Sequence] = []  # kept for latency accounting
        self.rejected: Dict[int, str] = {}  # uid -> why submit refused it
        # uid -> terminal outcome: finished / expired / quarantined / shed /
        # rejected (only "finished" rows are complete outputs)
        self.outcomes: Dict[int, str] = {}
        self._seen_uids: set = set()
        self._t_submit: Dict[int, float] = {}  # uid -> submit time
        self._any_deadline = deadline is not None  # no watchdog work if off
        self._fault_step = 0  # dispatches seen (the FaultPlan's clock)
        self._oom_waves = 0  # admission waves stalled by an oom fault
        self._evict_pending: List[int] = []
        # (host block, host valid, host poison, ready event, [(slot, uid)])
        # of dispatched-but-unread macro steps
        self._inflight: collections.deque = collections.deque()
        # live upgrade: serve/upgrade.py attaches an UpgradeManager here
        # and the swap drives upgrade_state serving -> relayout -> swapped
        self.upgrade = None
        self.upgrade_state = "serving"
        self._held_for_upgrade: List[Request] = []
        self.n_upgrades = 0  # completed hot swaps since construction
        self.last_upgrade_pause_ms: Optional[float] = None
        self.n_decode_dispatches = 0
        self.n_decode_steps = 0  # dispatches * k (loop steps executed)
        # admission groups prefilled (both pools in speculative mode; the
        # reference counts the draft's prefill as a second one)
        self.n_prefills = 0
        self.n_host_syncs = 0  # blocking device->host reads
        self.n_tokens = 0  # generated tokens (incl. prefill first tokens)
        self.n_admitted = 0  # requests that got a slot (and their pages)
        self.n_quarantined = 0  # NaN/Inf-poisoned slots evicted
        self.n_expired = 0  # deadline-evicted requests (active or queued)
        self.n_shed = 0  # queued requests dropped by queue-age shedding
        self.n_faults_injected = 0  # FaultPlan records that fired
        self.n_degraded_admissions = 0  # full-reservation paged admissions
        self.n_spec_proposed = 0  # draft tokens offered to the target
        self.n_spec_accepted = 0  # draft tokens the target kept
        self.n_spec_fallbacks = 0  # draft faults that tripped plain decode
        # paged-mode telemetry (zero on a dense pool)
        self.n_prefix_hits = 0  # admissions served from resident pages
        self.n_prefix_misses = 0  # prefix probes that found no full chain
        self.n_prefix_stalls = 0  # hits deferred on tail-page backpressure
        self.n_pages_allocated = 0  # fresh pages handed out
        self.n_prefix_tail_steps = 0  # masked decode steps of hit waves
        self.n_held_for_upgrade = 0  # submits held across a swap window
        # drained windows: drain() adds the window counters here
        self.lifetime: Dict[str, int] = {c: 0 for c in _WINDOW_COUNTERS}
        self._configure(cfg, params, speculative)

    def _configure(self, cfg, params, speculative):
        """Build -- or, on a live upgrade, REBUILD -- everything derived
        from the model: the checks of the configuration, the slot pools
        and paging metadata, the decode state and the step functions.
        ``_apply_upgrade`` calls it again with the grown model after
        quiescing, which is the swap's pool re-layout; every host-side
        queue and counter lives in ``__init__`` and survives."""
        capacity, max_len = self.capacity, self.max_len
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
        self.speculative = speculative
        self._spec_fallback = False  # draft faulted: plain macro decode
        self._arena_degraded = False  # paged arena faulted: no sharing
        dev = self.device
        self._build_pools(self._pool_arg, self.pages_arg)
        # persistent device-resident decode state: (tokens, positions,
        # remaining, eos_ids, done) -- idle slots are done
        self._state = (torch.zeros(capacity, dtype=torch.int32, device=dev),
                       torch.zeros(capacity, dtype=torch.int32, device=dev),
                       torch.zeros(capacity, dtype=torch.int32, device=dev),
                       torch.full((capacity,), -1, dtype=torch.int32,
                                  device=dev),
                       torch.ones(capacity, dtype=torch.bool, device=dev))
        # per-slot sampling chains (None when greedy): (capacity, 2) int64
        # threefry keys, zero on idle slots
        self._keys = None if self.sampling is None else torch.zeros(
            (capacity, 2), dtype=torch.int64, device=dev)
        self.free = list(range(capacity))[::-1]  # pop -> slot 0..
        self._loop = make_slot_decode_loop(cfg, self.k, self.sampling)
        self._prefill = make_prefill_admit_step(cfg, self.sampling)
        if speculative is not None:
            cfg_d = speculative.cfg
            # the plain loop above stays as the degradation ladder's target
            self._spec_loop = make_speculative_loop(
                cfg, cfg_d, speculative.d, self.k, self.sampling)
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
        # a swap's rebuild drops the old pools first: both models' pools
        # at once would need the memory of two engines
        self._pools = ()
        pools = []
        for i, (f, c) in enumerate(zip(fams, cfgs)):
            if metas[i] is not None:
                p, metas[i] = paged_lib.build_paged_pool(
                    f, c, cap, max_len, n_pages=n_pages, device=dev)
            else:
                p = f.init_cache(c, cap, max_len, device=dev)
            pools.append(p)
        self._pools = tuple(pools)
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
        # position, and a ring is rebuilt from copies when it keeps at
        # least one page of slack over the window (the admission prefill's
        # partial tail page always clobbers the oldest ring page, so a
        # slack-less ring has no intact shareable page); off under
        # speculation and for every family but the transformer (a
        # recurrent state has no pages to share), as in the reference
        window = self.cfg.window
        self._windowed = bool(window)
        ring_ok = True
        if window and metas[0] is not None:
            ring_ok = ((metas[0].nblk - 1) * metas[0].page + 1 >= window
                       and metas[0].nblk > 1)
        self._prefix_ok = (metas[0] is not None
                           and self.speculative is None
                           and self.cfg.family == "transformer"
                           and metas[0].page > 0 and ring_ok)

    @property
    def pool(self):
        """The target model's slot pool."""
        return self._pools[0]

    @property
    def pool_d(self):
        """The draft model's slot pool (None unless speculative)."""
        return self._pools[1] if len(self._pools) > 1 else None

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

    def lifetime_totals(self) -> Dict[str, int]:
        """Window counters summed over every drained window PLUS the live
        one: the view since construction that ``drain()`` leaves intact."""
        return {c: self.lifetime[c] + getattr(self, c)
                for c in _WINDOW_COUNTERS}

    # ------------------------------------------------------------- admission
    def _reject(self, uid: int, why: str):
        """Graceful rejection: record, journal and keep serving.  The uid
        is NOT marked seen -- a corrected resubmission is fine."""
        self.rejected[uid] = why
        self.outcomes[uid] = "rejected"
        if self.journal is not None:
            self.journal.record_reject(uid, why)

    def _invalid_reason(self, req: Request) -> Optional[str]:
        """Every malformed-request class, in one place: a bad request is
        recorded, never raised, so it cannot kill in-flight sequences."""
        P, nc = len(req.prompt), req.n_committed
        if req.max_new_tokens < 1:
            return ("max_new_tokens must be >= 1 "
                    "(prefill always emits the first token)")
        if P < 1:
            return "empty prompt"
        if not (0 <= nc < req.max_new_tokens and nc < P):
            return (f"n_committed {nc} must lie in [0, max_new_tokens) "
                    "and leave at least one real prompt token")
        if req.eos_id is not None and not (
                0 <= req.eos_id < self.cfg.vocab_size):
            return (f"eos_id {req.eos_id} outside the vocabulary "
                    f"[0, {self.cfg.vocab_size})")
        if req.deadline is not None and req.deadline <= 0:
            return f"deadline must be > 0 (got {req.deadline})"
        toks = np.asarray(req.prompt)
        if int(toks.min()) < 0 or int(toks.max()) >= self.cfg.vocab_size:
            return (f"prompt tokens outside the vocabulary "
                    f"[0, {self.cfg.vocab_size})")
        # a resume's committed run sits in its prompt: the cache needs
        # P - nc original + max_new positions
        if P - nc + req.max_new_tokens > self.max_len:
            return (f"prompt {P - nc} + {req.max_new_tokens} new tokens "
                    f"exceeds max_len {self.max_len}")
        if self._alloc is not None:
            need = max(paged_lib.pages_needed(P, req.max_new_tokens - nc, m)
                       for m in self._metas if m is not None)
            if need > self._alloc.meta.n_pages:
                # no eviction wave can ever make room for it: queued, it
                # would bounce off admission forever
                return (f"needs {need} pages but the arena holds only "
                        f"{self._alloc.meta.n_pages} (raise --pages or "
                        f"shrink the request)")
        return None

    def submit(self, req: Request):
        if req.uid in self._seen_uids or any(
                r.uid == req.uid for r in self._held_for_upgrade):
            # a duplicate uid is a caller bug, not a malformed request
            raise ValueError(f"request uid {req.uid} already submitted")
        if self.upgrade_state == "relayout":
            # mid-swap the geometry (and with it what is valid) is being
            # rebuilt: hold the request and submit it once the swap lands
            self._held_for_upgrade.append(req)
            self.n_held_for_upgrade += 1
            self._t_submit.setdefault(req.uid, faults_lib.monotonic())
            return
        self._submit_checked(req)

    def _submit_checked(self, req: Request):
        """Validate and enqueue (``submit`` past the duplicate and swap
        gates; also the release path of held submissions)."""
        why = self._invalid_reason(req)
        if why is not None:
            self._t_submit.pop(req.uid, None)
            self._reject(req.uid, f"request {req.uid}: {why}")
            return
        self._seen_uids.add(req.uid)
        # setdefault: a request held across a swap keeps its submit time,
        # so deadlines and shedding count the held window too
        self._t_submit.setdefault(req.uid, faults_lib.monotonic())
        if req.deadline is not None:
            self._any_deadline = True
        if self.journal is not None:
            self.journal.record_submit(req)
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
        no-prefill admission path.  A ring cannot alias resident pages
        (the slot's ring keeps wrapping over them): a ring hit looks up
        only the last ``nblk - 1`` full pages (the chained digest of the
        last commits to the whole prefix), pins those copies until
        ``_admit_hits`` has copied them into its own ring pages, and
        allocates all its pages privately.
        """
        P = len(req.prompt)
        n_new = req.max_new_tokens - req.n_committed
        alloc = self._alloc
        ns_all = tuple(self._ns_of.values())
        info = {"hit": False, "share": 0, "nreg": 0, "digests": None,
                "pids": None, "resident": None}
        if self._prefix_ok and not self._arena_degraded:
            meta = self._metas[0]
            digests = paged_lib.prefix_digests(req.prompt, meta.page)
            info["digests"] = digests
            share = (P - 1) // meta.page  # >= 1 private tail token stays
            # a ring rebuilds from its last nblk - 1 full pages only (the
            # prefill's tail page clobbered the oldest ring page)
            nreg = min(share, meta.nblk - 1) if self._windowed else share
            resident = alloc.lookup(digests[share - nreg:share]) \
                if nreg > 0 else None
            if resident is not None:
                # pin the resident pages BEFORE the tail alloc: alloc()
                # reclaims zero-ref retained pages when the free list runs
                # dry, which could hand back the very pages just looked
                # up as this slot's private tail
                alloc.incref(resident)
                total = paged_lib.pages_needed(P, n_new, meta)
                # a ring hit's pages are ALL private (the resident copies
                # are sources of its rebuild, not aliased)
                tail = alloc.alloc(total if self._windowed
                                   else total - share, ns=ns_all)
                if tail is None:
                    # tail backpressure, not a registry miss: unpin and
                    # wait for the next eviction wave
                    self._zero_pending.extend(alloc.release(resident))
                    self.n_prefix_stalls += 1
                    return None
                info.update(hit=True, share=share, nreg=nreg)
                if self._windowed:
                    info.update(pids=tail, resident=list(resident))
                else:
                    info["pids"] = list(resident) + tail
                self.n_prefix_hits += 1
                self.n_pages_allocated += len(tail)
                return info
            if nreg > 0:
                self.n_prefix_misses += 1
        paged_metas = [m for m in self._metas if m is not None]
        # degradation ladder: once the arena has held a poisoned slot,
        # sharing is off and every admission reserves its FULL block table
        # (dense-pool semantics on paged storage)
        need = max(m.nblk for m in paged_metas) if self._arena_degraded \
            else max(paged_lib.pages_needed(P, n_new, m)
                     for m in paged_metas)
        pids = alloc.alloc(need, ns=ns_all)
        if pids is None:
            return None
        info["pids"] = pids
        self.n_pages_allocated += len(pids)
        if self._arena_degraded:
            self.n_degraded_admissions += 1
        return info

    def _admit_batch(self, now: Optional[float]):
        """Admit every arrived request a free slot can take: ONE prefill
        dispatch, ONE pool/state copy and ONE host sync per prefill-bucket
        group.  A paged pool puts a page-allocation pass in front
        (all-or-nothing per request: the first request that cannot get its
        pages returns itself and everything grabbed after it to the FRONT
        of the queue, in order) and sends prefix hits to the no-prefill
        path, one host sync for all of them.  An injected ``oom`` stalls
        whole waves: nothing is admitted and the requests stay queued."""
        if self._oom_waves > 0:
            if self.waiting:
                self._oom_waves -= 1
            return
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

    def _set_state(self, idx, first_n, plens, rem0, eos_new, keys_n=None):
        """Write the admitted rows' decode state (and sampling chains) in
        place."""
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
        if keys_n is not None:
            self._keys.index_copy_(0, idx, keys_n)

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
        keys = None
        if self.sampling is None:
            first, rows = self._prefill(self.params, padded_d, plens_d, rows)
        else:
            # chain roots are derived from (seed, uid) on the device in the
            # same prefill; ``skips`` replays a resume's committed run (one
            # split a token), so its first fresh draw takes the key the
            # uninterrupted run would have.  It stays on the host: the
            # prefill then bounds its loop without reading the device
            uids = np.zeros((npad,), np.int64)
            uids[:n] = [r.uid for r, _ in group]
            skips = np.zeros((npad,), np.int64)
            skips[:n] = [r.n_committed for r, _ in group]
            first, rows, keys = self._prefill(
                self.params, padded_d, plens_d, rows, self._to_device(uids),
                torch.from_numpy(skips))
            keys = keys[:n]
        idx = self._to_device(slots)
        if self._windowed and self._prefix_ok and not self._arena_degraded:
            self._register_ring_pages(group, rows, n)
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
        self._set_state(idx, first_n, plens[:n], *self._budgets(group),
                        keys)
        self.n_prefills += 1
        first_host = first_n.cpu().numpy()
        self.n_host_syncs += 1
        t = faults_lib.monotonic()
        for j, (r, a) in enumerate(group):
            seq = self._admitted(r, int(slots[j]), int(first_host[j]), t)
            if a is not None and a["digests"] and not self._windowed:
                # the pages the prompt covers in full now hold its
                # prefill-built KV: make them shareable (tail pages built
                # by the hit path's decode steps are never registered;
                # rings registered their copies before the scatter)
                reg = len(r.prompt) // self._metas[0].page
                if reg:
                    self._alloc.register(a["digests"][:reg], a["pids"][:reg])
            self._finish_if_done(seq, seq.tokens[-1])
        if self.journal is not None:
            self.journal.flush()  # rides the admission sync just paid

    def _register_ring_pages(self, group, rows, n):
        """Ring prefix cache, at a miss admission: the admit scatter is
        about to write ring-wrapped pages, which the slot keeps
        overwriting, so first copy each prompt's last intact full pages
        (at most ``nblk - 1``) out of the prefill rows into fresh
        registry-only pages and register them.  Best effort: a request
        whose copy pages are not free is admitted without registering.
        The registered pages retire to the LRU at once, their bytes kept;
        a first-writer-wins loser comes back on the zero list."""
        meta = self._metas[0]
        reg_pids = np.full((n, meta.nblk), meta.sentinel, np.int64)
        reg_blk = np.zeros((n, meta.nblk), np.int64)
        records = []
        for j, (r, a) in enumerate(group):
            if a is None or not a["digests"]:
                continue
            share = (len(r.prompt) - 1) // meta.page
            nreg = min(share, meta.nblk - 1)
            if nreg <= 0:
                continue
            got = self._alloc.alloc(nreg)
            if got is None:
                continue
            for t, ab in enumerate(range(share - nreg, share)):
                reg_pids[j, t] = got[t]
                reg_blk[j, t] = ab % meta.nblk  # absolute page ab's block
            records.append((a["digests"][share - nreg:share], got))
        if not records:
            return
        real = {key: {name: leaf[:, :n] for name, leaf in grp.items()}
                for key, grp in rows.items()}
        paged_lib.register_copy(self.pool, self._to_device(reg_pids),
                                self._to_device(reg_blk), real, meta)
        for digests, got in records:
            self._alloc.register(digests, got)
            self._zero_pending.extend(self._alloc.release(got))

    def _admitted(self, r: Request, slot: int, first: int,
                  t: float) -> _Sequence:
        """Book an admitted request: a resume re-enters holding its
        committed run (output continuity without replaying delivered
        tokens), then the first token its admission drew."""
        prior = ([int(x) for x in r.prompt[len(r.prompt) - r.n_committed:]]
                 if r.n_committed else [])
        seq = _Sequence(r, slot, pos=len(r.prompt), tokens=prior + [first],
                        t_first=t)
        self.active[slot] = seq
        self.n_tokens += 1
        self.n_admitted += 1
        if self.journal is not None:
            self.journal.record_tokens(r.uid, [first])
        return seq

    @staticmethod
    def _budgets(pairs):
        """(remaining after the first token, eos id or -1) per request; a
        resume's committed run already spent part of its budget."""
        rem0 = np.array([r.max_new_tokens - r.n_committed - 1
                         for r, _ in pairs], np.int32)
        eos = np.array([-1 if r.eos_id is None else r.eos_id
                        for r, _ in pairs], np.int32)
        return rem0, eos

    def _admit_hits(self, pairs):
        """No-prefill admission of prefix hits: point the slots' leading
        block-table entries at the resident shared pages (a ring: copy the
        resident registry pages into the slot's own ring pages, absolute
        page ``ab`` into the page of block ``ab % nblk``, where a
        sequential fill of the ring would have left it), then run only
        the private tail tokens (at most one page of them) through masked
        decode steps over the whole pool -- rows outside the wave are
        ``done``, so their writes go to the scratch page and nothing of
        theirs changes.  The reference scans a full page of steps; steps
        past the longest tail change nothing, so the loop stops there.
        Sampled, each row's chain is derived on the device from (seed,
        uid), advanced past a resume's committed run (``n_committed``
        splits), and advanced once more by the draw at its last tail step,
        as the skipped prefill would have; a step where no row ends draws
        nothing.  One host sync reads the first tokens."""
        meta = self._metas[0]
        cap, dev = self.capacity, self.device
        slots, bt_rows = self._take_slots(pairs)
        wave = np.zeros((cap,), bool)
        tail_len = np.zeros((cap,), np.int32)
        pos0 = np.zeros((cap,), np.int32)
        tail_tokens = np.zeros((cap, meta.page), np.int32)
        plens = np.zeros((len(pairs),), np.int32)
        uids = np.zeros((cap,), np.int64)
        skips = np.zeros((cap,), np.int64)
        src_pids = np.full((len(pairs), meta.nblk), meta.sentinel, np.int64)
        dst_pids = np.full((len(pairs), meta.nblk), meta.sentinel, np.int64)
        for j, (r, a) in enumerate(pairs):
            slot = slots[j]
            p0 = a["share"] * meta.page
            if self._windowed:
                for t, ab in enumerate(range(a["share"] - a["nreg"],
                                             a["share"])):
                    src_pids[j, t] = a["resident"][t]
                    dst_pids[j, t] = a["pids"][ab % meta.nblk]
            tail = np.asarray(r.prompt[p0:], np.int32)
            wave[slot] = True
            pos0[slot] = p0
            tail_len[slot] = len(tail)
            tail_tokens[slot, :len(tail)] = tail
            plens[j] = len(r.prompt)
            uids[slot] = r.uid
            skips[slot] = r.n_committed
        idx = self._to_device(slots)
        paged_lib.set_block_tables(self.pool, idx,
                                   self._to_device(bt_rows[0]), meta)
        if self._windowed:
            paged_lib.ring_restore_copy(self.pool, self._to_device(src_pids),
                                        self._to_device(dst_pids), meta)
        wave_d, tl_d, p0_d, toks_d = (self._to_device(a) for a in (
            wave, tail_len, pos0, tail_tokens))
        first = torch.zeros(cap, dtype=torch.int32, device=dev)
        chain = None
        if self.sampling is not None:
            chain = sampling_lib.request_key(self.sampling.seed,
                                             self._to_device(uids))
            sk_d = self._to_device(skips)
            for i in range(int(skips.max())):
                # a resume's committed run consumed one split a token
                advanced, _ = sampling_lib.next_keys(chain)
                chain = torch.where((i < sk_d)[:, None], advanced, chain)
        pool = self.pool
        for j in range(int(tail_len.max())):
            live = wave_d & (j < tl_d)
            logits, pool = self.fam.decode_step_slots(
                self.params, toks_d[:, j].contiguous(), p0_d + j, pool,
                self.cfg, done=~live)
            self.n_prefix_tail_steps += 1
            last = live & (tl_d == j + 1)
            if chain is None:
                nxt = logits.argmax(-1).to(torch.int32)
            elif (tail_len[wave] == j + 1).any():  # host arrays: no sync
                advanced, subs = sampling_lib.next_keys(chain)
                nxt = sampling_lib.sample_logits(logits, subs, self.sampling)
                # the chain advances exactly once: at the draw of the
                # row's first sampled token
                chain = torch.where(last[:, None], advanced, chain)
            else:
                continue  # no row's tail ends at this step: no draw
            first = torch.where(last, nxt, first)
        self._pools = (pool,) + self._pools[1:]
        if self._windowed:
            # the rebuild has read the resident copies: unpin them (still
            # registered, they retire to the LRU with their bytes)
            for _, a in pairs:
                self._zero_pending.extend(self._alloc.release(a["resident"]))
        first_n = first[idx]
        self._set_state(idx, first_n, plens, *self._budgets(pairs),
                        None if chain is None else chain[idx])
        first_host = first_n.cpu().numpy()
        self.n_host_syncs += 1
        t = faults_lib.monotonic()
        for j, (r, _) in enumerate(pairs):
            seq = self._admitted(r, int(slots[j]), int(first_host[j]), t)
            self._finish_if_done(seq, seq.tokens[-1])
        if self.journal is not None:
            self.journal.flush()

    # ------------------------------------------------------------- lifecycle
    def _finish_if_done(self, seq: _Sequence, last_token: int):
        """Host-side stopping rule -- the mirror of the on-device rule (the
        device marks the row done at the same token)."""
        if (len(seq.tokens) >= seq.req.max_new_tokens
                or (seq.req.eos_id is not None
                    and last_token == seq.req.eos_id)):
            self._retire(seq, "finished")

    def _retire(self, seq: _Sequence, outcome: str):
        """Retire a sequence with a terminal ``outcome``: normal completion
        and forced eviction (expiry, quarantine) alike.  Partial tokens are
        still delivered: a request the watchdog killed keeps everything it
        committed."""
        seq.t_done = faults_lib.monotonic()
        self.finished[seq.req.uid] = np.asarray(seq.tokens, np.int32)
        self.outcomes[seq.req.uid] = outcome
        if self.journal is not None:
            self.journal.record_finish(seq.req.uid, outcome)
        self.retired.append(seq)
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
        for pool, meta in zip(self._pools, self._metas):
            if meta is not None:
                paged_lib.evict_clear(pool, idx, self._to_device(
                    np.asarray(zero, np.int64)), meta)
            else:
                for grp in pool.values():
                    for leaf in grp.values():
                        leaf.index_fill_(1, idx, 0)
        tokens, positions, remaining, eos, done = self._state
        tokens.index_fill_(0, idx, 0)
        positions.index_fill_(0, idx, 0)
        remaining.index_fill_(0, idx, 0)
        eos.index_fill_(0, idx, -1)
        done.index_fill_(0, idx, True)
        if self._keys is not None:
            self._keys.index_fill_(0, idx, 0)
        self.free.extend(self._evict_pending)
        self._evict_pending.clear()

    def _quarantine(self, seq: _Sequence):
        """Evict a slot whose logits went non-finite.  The device row froze
        itself at the bad step (the in-loop sentinel folds into the done
        mask, committing nothing from it), so this is a forced retirement
        -- plus arena degradation: a paged pool can no longer trust its
        resident prefix pages, so the registry is flushed and admissions
        fall back to full reservation."""
        self.n_quarantined += 1
        self._retire(seq, "quarantined")
        if self._alloc is not None and not self._arena_degraded:
            self._arena_degraded = True
            self._zero_pending.extend(self._alloc.flush_registry())
            self._prefix_ok = False

    def _deadline_of(self, req: Request) -> Optional[float]:
        return req.deadline if req.deadline is not None else self.deadline

    def _age(self, req: Request, now: Optional[float]) -> float:
        """Seconds since the request entered the system: the trace clock
        when arrivals are replayed, the engine's clock since ``submit``
        otherwise."""
        if now is not None:
            return now - req.arrival
        t = faults_lib.monotonic()
        return t - self._t_submit.get(req.uid, t)

    def _expire(self, now: Optional[float]):
        """Deadline watchdog and queue-age load shedding.  Nothing to do
        (one check) unless a TTL or a shed threshold is configured."""
        if not self._any_deadline and self.shed_age is None:
            return
        for seq in list(self.active.values()):
            ddl = self._deadline_of(seq.req)
            if ddl is not None and self._age(seq.req, now) > ddl:
                self.n_expired += 1
                self._retire(seq, "expired")
        if not self.waiting:
            return
        keep = collections.deque()
        for r in self.waiting:
            age = self._age(r, now)
            ddl = self._deadline_of(r)
            if ddl is not None and age > ddl:
                # expired before it got a slot: an empty output, the same
                # outcome as an active expiry
                self.n_expired += 1
                self.finished[r.uid] = np.zeros((0,), np.int32)
                self.outcomes[r.uid] = "expired"
                if self.journal is not None:
                    self.journal.record_finish(r.uid, "expired")
            elif self.shed_age is not None and age > self.shed_age:
                # sustained backpressure: drop the oldest queued work with
                # an explicit outcome instead of serving everyone late; the
                # uid may be resubmitted, and its age then starts again
                # (the reference keeps the old submit time and sheds the
                # retry at once)
                self.n_shed += 1
                self.outcomes[r.uid] = "shed"
                self.rejected[r.uid] = (
                    f"shed after {age:.3f}s queued (> {self.shed_age})")
                self._seen_uids.discard(r.uid)
                self._t_submit.pop(r.uid, None)
                if self.journal is not None:
                    self.journal.record_finish(r.uid, "shed")
            else:
                keep.append(r)
        self.waiting = keep

    # ----------------------------------------------------------- live upgrade
    def _apply_upgrade(self, mgr) -> None:
        """Hot-swap the grown model under live traffic, driven by an
        attached ``serve.upgrade.UpgradeManager`` at a block boundary
        (``poll`` from ``step``/``run``).

        The pause is one quiesce: every in-flight block is read back and
        its tokens committed, each mid-flight sequence becomes a resume
        request (original prompt followed by its committed run,
        ``n_committed`` marking the run), everything derived from the
        model is rebuilt for the grown one, and the resumes re-enter
        through the ordinary admission path at the FRONT of the queue.
        Nothing is dropped: a resume needs the positions and pages its
        original request needed, so it is admissible by construction.
        The manager prewarmed the grown model's path, so the pause holds
        no first use of a kernel or a library."""
        t0 = faults_lib.monotonic()
        self.upgrade_state = "relayout"
        while self._inflight:
            self._process(self._inflight.popleft())
        self._flush_evictions()
        # every page live at the quiesce is lost by the swap (its bytes are
        # activations of the old model), so what the swap costs in pages
        # is the resume wave's re-prefill
        pages_at_swap = self.pages_in_use
        resumes: List[Request] = []
        for seq in sorted(self.active.values(),
                          key=lambda q: (q.t_first, q.req.uid)):
            r = seq.req
            orig = (r.prompt[:len(r.prompt) - r.n_committed]
                    if r.n_committed else r.prompt)
            resumes.append(Request(
                uid=r.uid,
                prompt=np.asarray(list(orig) + seq.tokens, np.int32),
                max_new_tokens=r.max_new_tokens, eos_id=r.eos_id,
                arrival=r.arrival, deadline=r.deadline,
                n_committed=len(seq.tokens)))
        self.active.clear()
        self._evict_pending.clear()
        spec = mgr.spec_config()
        self._configure(mgr.cfg_tgt, mgr.grown_params, spec)
        if spec is not None and any(self._invalid_reason(r) is not None
                                    for r in resumes):
            # the draft's pool raised the shared arena's page need (a
            # request reserves the most any pool needs) past an explicit
            # page budget for an in-flight resume: dropping nothing comes
            # before free speculation, so swap without the draft
            mgr.disable_spec("draft page need exceeds the shared arena "
                             "for an in-flight request")
            self._configure(mgr.cfg_tgt, mgr.grown_params, None)
        # queued requests were validated under the OLD geometry: one that
        # became unservable must not livelock admission (resumes skip this
        # by construction)
        keep: collections.deque = collections.deque()
        for r in self.waiting:
            why = self._invalid_reason(r)
            if why is None:
                keep.append(r)
            else:
                self._seen_uids.discard(r.uid)
                self._reject(r.uid, f"request {r.uid}: {why} "
                             "(post-upgrade geometry)")
        keep.extendleft(reversed(resumes))
        self.waiting = keep
        self.n_upgrades += 1
        self.upgrade_state = "swapped"
        held, self._held_for_upgrade = self._held_for_upgrade, []
        for r in held:
            self._submit_checked(r)
        if self.journal is not None:
            # last-submit-wins resume records: a crash right after the
            # swap replays exactly these requests
            for r in resumes:
                self.journal.record_submit(r)
            self.journal.flush()
        pause_ms = (faults_lib.monotonic() - t0) * 1e3
        self.last_upgrade_pause_ms = pause_ms
        # the reference's bill: each resume's pages at its full budget past
        # its prompt (the admission reserves max_new - n_committed)
        pages_reprefill = 0
        if self._alloc is not None:
            pages_reprefill = sum(
                max(paged_lib.pages_needed(len(r.prompt), r.max_new_tokens,
                                           m)
                    for m in self._metas if m is not None)
                for r in resumes)
        mgr._swapped(self, pause_ms, resumes, pages_resident=pages_at_swap,
                     pages_reprefilled=pages_reprefill)

    # ---------------------------------------------------------------- faults
    def _inject(self, f):
        """Fire one FaultPlan record (from ``_dispatch``, only when a plan
        is attached)."""
        self.n_faults_injected += 1
        if f.kind == "crash":
            # kill -9 at a step boundary: journaled state survives, unread
            # in-flight blocks do not
            if self.journal is not None:
                self.journal.flush()
            raise faults_lib.EngineKilled(
                f"injected crash at engine step {self._fault_step}")
        if f.kind in ("slow", "hang"):
            faults_lib.sleep(f.duration)
            return
        if f.kind == "oom":
            self._oom_waves += max(int(f.duration), 1)
            return
        if f.kind == "malformed":
            # a hostile request arriving mid-trace; the rejection path must
            # absorb it without disturbing in-flight work
            self.submit(Request(uid=-(1000 + self._fault_step),
                                prompt=np.zeros((0,), np.int32),
                                max_new_tokens=1))
            return
        # kind == "nan": corrupt a live slot's cache bytes on the device;
        # the NaN flows through real attention into real logits, where the
        # in-loop sentinel must catch it
        slot = f.slot if f.slot in self.active else (
            min(self.active) if self.active else None)
        if slot is None or f.pool >= len(self._pools):
            return
        # a paged pool poisons the slot's first page (attention reads it
        # every step); the shared id space makes it a page of every paged
        # pool.  A dense pool poisons the slot's rows
        pid = self._slot_pages[slot][0] \
            if self._metas[f.pool] is not None else 0
        faults_lib.poison_pool(self._pools[f.pool], slot, pid)

    # ------------------------------------------------------------- step loop
    def _dispatch(self):
        """Enqueue one macro step (K decode steps, or K whole speculative
        draft→verify→commit blocks) and its readback, with no host sync.
        An attached FaultPlan fires the faults due at this dispatch
        first."""
        if self.faults is not None:
            self._fault_step += 1
            for f in self.faults.due(self._fault_step):
                self._inject(f)
        tokens, positions, remaining, eos_ids, done = self._state
        chains = () if self._keys is None else (self._keys,)
        if self.speculative is not None and not self._spec_fallback:
            (block, valid, poison, dbad, tokens, positions, remaining, done,
             pool_t, pool_d, *chains, n_prop, n_acc) = \
                self._spec_loop(self.params, self.speculative.params, tokens,
                                positions, remaining, eos_ids, done,
                                *self._pools, *chains)
            self._pools = (pool_t, pool_d)
            # acceptance telemetry and the draft-fault flag in one tensor
            stats = torch.stack([n_prop, n_acc, dbad.long()])
        else:
            # a speculative engine whose draft misbehaved keeps serving
            # through the plain macro loop on its TARGET pool
            (block, valid, poison, tokens, positions, remaining, done,
             pool, *chains) = self._loop(
                self.params, tokens, positions, remaining, eos_ids, done,
                self.pool, *chains)
            self._pools = (pool,) + self._pools[1:]
            stats = None
        if chains:
            self._keys = chains[0]
        self._state = (tokens, positions, remaining, eos_ids, done)
        host, ready = (block, valid, poison, stats), None
        if self.device.type == "cuda":
            host = tuple(None if t is None else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record()
        self.n_decode_dispatches += 1
        self.n_decode_steps += self.k
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
                new = [int(t) for t in block[:, slot][vm]]
                seq.pos += nv
                seq.tokens.extend(new)
                self.n_tokens += nv
                if self.journal is not None:
                    self.journal.record_tokens(uid, new)
                self._finish_if_done(seq, seq.tokens[-1])
            if poison[slot] and self.active.get(slot) is seq:
                # the row froze itself at the non-finite step; nothing
                # from that step was committed
                self._quarantine(seq)
        if self.journal is not None:
            self.journal.flush()  # rides the block readback just paid

    def step(self, now: Optional[float] = None):
        """One synchronous engine iteration: poll a live upgrade, expire,
        evict, admit arrived requests into free slots, run one macro step,
        and read it back."""
        if self.upgrade is not None:
            self.upgrade.poll(self)
        self._expire(now)
        self._flush_evictions()
        self._admit_batch(now)
        if self.active:
            self._dispatch()
        while self._inflight:
            self._process(self._inflight.popleft())

    def run(self, requests=None, *, realtime: bool = False,
            pipeline: bool = True):
        """Serve until every submitted request finishes.

        ``realtime=True`` replays ``Request.arrival`` offsets against the
        engine's clock (benchmark traces): a request is admitted once its
        arrival has passed, and an idle engine sleeps to the next arrival.
        Otherwise arrivals are ignored and admission is slot-limited.

        ``pipeline=True`` double-buffers readback: block N+1 is enqueued
        before the host waits on block N, so admissions chain onto the
        latest enqueued state (a queued request waits at most one extra
        block).  ``pipeline=False`` runs ``step`` after ``step``, one sync
        a block.  Returns {uid: generated tokens} for the requests that
        finished during THIS call."""
        already = set(self.finished)
        for r in requests or ():
            self.submit(r)
        t0 = faults_lib.monotonic()

        def wall_now():
            return faults_lib.monotonic() - t0 if realtime else None

        if not pipeline:
            while self.waiting or self.active or self._inflight:
                now = wall_now()
                if realtime and not self.active and self.waiting:
                    nxt = min(r.arrival for r in self.waiting)
                    if nxt > now:
                        faults_lib.sleep(nxt - now)
                        now = wall_now()
                self.step(now=now)
        else:
            while self.waiting or self.active or self._inflight:
                now = wall_now()
                if (realtime and not self.active and not self._inflight
                        and self.waiting):
                    nxt = min(r.arrival for r in self.waiting)
                    if nxt > now:
                        faults_lib.sleep(nxt - now)
                        now = wall_now()
                if self.upgrade is not None:
                    self.upgrade.poll(self)
                self._expire(now)
                self._flush_evictions()
                self._admit_batch(now)
                if self.active:
                    self._dispatch()
                # wait on the OLDEST block only once a newer one is
                # enqueued (or nothing is left to dispatch)
                if len(self._inflight) >= (2 if self.active else 1):
                    self._process(self._inflight.popleft())
        self._flush_evictions()
        return {uid: toks for uid, toks in self.finished.items()
                if uid not in already}

    def drain(self):
        """Return and clear the accumulated results, and roll the
        telemetry window.

        A long-lived server calls this periodically: ``finished``,
        ``retired``, ``rejected``, ``outcomes`` and the uid set otherwise
        grow with every request ever served, and the window counters would
        turn
        every derived rate into an average since construction.  The
        counters are added to ``self.lifetime`` and reset to zero
        (``lifetime_totals()`` keeps the whole view); drained uids become
        submittable again."""
        out = self.finished
        self.finished = {}
        self.retired = []
        self.rejected = {}
        self.outcomes = {}
        self._seen_uids.difference_update(out)
        for uid in out:
            self._t_submit.pop(uid, None)
        for c in _WINDOW_COUNTERS:
            self.lifetime[c] += getattr(self, c)
            setattr(self, c, 0)
        return out
