"""Live-growth serving: hot-swap Mango-grown weights into a running
engine with zero dropped requests.

The paper's multi-linear growth is (approximately) function-preserving:
at swap time the grown target computes the source's function.  That
turns a model upgrade into a serving event instead of a redeploy.
:class:`UpgradeManager` drives it end to end:

    serving ──start()──▶ growing ──▶ ready ──poll()──▶ relayout ──▶ swapped
                            │                                         │
                            └────────────▶ failed (engine keeps serving
                                                   the source model)

* **growing** -- ``core/grow.py: grow_from_source`` runs Mango (or another
  growth method) on the engine's CURRENT weights, optionally on a
  background thread while the engine keeps serving the source.  The
  growth draws from a ``torch.Generator`` seeded with ``seed``.
* **ready** -- the grown model's path is prewarmed: a scratch engine of the
  post-swap geometry runs the reference's scratch traffic, one admission
  per (power-of-two group, prefill bucket), so the swap's pause holds no
  first use of anything (no kernel build, no library load, no first
  launch of a kernel or of a library routine).
* **relayout -> swapped** -- at the first block boundary whose lifetime
  dispatch count has reached ``upgrade_at``, the engine quiesces, turns
  every mid-flight sequence into a resume request (original prompt
  followed by its committed run), rebuilds its pools and step functions
  for the grown model and re-admits the resumes through the ordinary
  admission path: token-exact continuations, nothing dropped
  (``engine._apply_upgrade``).
* **draft-after-swap** -- the old source is, by construction, a draft
  matched to its own grown target; when the pair probe passes, the swap
  turns the engine speculative with the source drafting.

Everything that can fail is checked in ``__init__`` and raises a named
:class:`UpgradeError` (family, servability, position range, vocabulary,
the draft pair), so a doomed upgrade dies before a single growth FLOP,
never mid-swap.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import serve_supported
from repro_torch.serve.engine import ContinuousBatchingEngine, Request
from repro_torch.serve.speculative import (
    SpeculativeConfig,
    spec_pair_supported,
)

UPGRADE_STATES = ("serving", "growing", "ready", "relayout", "swapped",
                  "failed")


class UpgradeError(RuntimeError):
    """A live upgrade that cannot work, detected before it starts."""


def probe_token_agreement(cfg_src, params_src, cfg_tgt, params_tgt,
                          prompts, *, gen: int = 8) -> float:
    """Fraction of greedy tokens on which source and target agree over a
    probe batch (through ``launch.serve.generate``): the measurable form
    of the paper's function-preservation claim (1.0 means the grown target
    continues every greedy sequence exactly where the source would)."""
    from repro_torch.launch.serve import generate
    from repro_torch.utils.pytree import tree_leaves

    dev = tree_leaves(params_src)[0].device
    x = torch.from_numpy(np.asarray(prompts, np.int32)).to(dev)
    a = generate(cfg_src, params_src, x, max_new_tokens=gen).cpu().numpy()
    b = generate(cfg_tgt, params_tgt, x, max_new_tokens=gen).cpu().numpy()
    return float((a == b).mean())


class UpgradeManager:
    """Grow ``engine.cfg`` into ``cfg_tgt`` and hot-swap it in.

    ``engine`` is the live :class:`ContinuousBatchingEngine` (the manager
    attaches as ``engine.upgrade``; the engine polls at block boundaries).
    ``cfg_tgt`` is the target config (same family: Mango maps within
    one).  ``method`` / ``rank`` / ``grow_steps`` / ``data_iter`` go to
    ``core/grow.py: grow_from_source`` (``grow_steps`` > 0 trains the
    operator on ``data_iter`` first, Eq. 7).  ``grow_noise`` is the
    operator init's noise scale, 0.0 by default: the untrained structured
    init then coincides with the Net2Net expansion, the most
    function-preserving init there is (depth growth keeps it approximate;
    :func:`probe_token_agreement` measures it); None takes the trainer's
    default (0.01).  ``grown_params`` skips growth and swaps these in.
    ``speculate_after``: ``"auto"`` turns draft-after-swap on when the pair
    probe passes and records why not otherwise, ``True`` makes a failed
    probe an :class:`UpgradeError`, ``False`` turns it off; ``spec_d`` is
    the post-swap depth.  ``upgrade_at`` is the least number of LIFETIME
    decode dispatches before the swap may land.  ``prewarm`` runs the
    grown path before the flip (off only for tests of the cold swap).
    ``probe_fp`` measures :func:`probe_token_agreement` on seeded prompts
    after growth (``fp_token_agreement``).
    """

    def __init__(self, engine: ContinuousBatchingEngine, cfg_tgt, *,
                 method: str = "mango", rank: int = 1,
                 grow_steps: int = 0, data_iter=None, grow_noise=0.0,
                 grown_params=None, speculate_after="auto",
                 spec_d: int = 4, upgrade_at: int = 0,
                 prewarm: bool = True, probe_fp: bool = False,
                 seed: int = 0):
        if engine.upgrade is not None and engine.upgrade.state not in (
                "swapped", "failed"):
            raise UpgradeError(
                "engine already has an upgrade in flight "
                f"(state {engine.upgrade.state!r})")
        cfg_src = engine.cfg
        if cfg_src.family != cfg_tgt.family:
            raise UpgradeError(
                f"growth operators map within one family: engine serves "
                f"{cfg_src.name!r} ({cfg_src.family}) but the target is "
                f"{cfg_tgt.name!r} ({cfg_tgt.family})")
        if cfg_src.vocab_size != cfg_tgt.vocab_size:
            raise UpgradeError(
                f"live upgrade needs an unchanged vocabulary (committed "
                f"tokens must stay valid): {cfg_src.vocab_size} -> "
                f"{cfg_tgt.vocab_size}")
        ok, why = serve_supported(cfg_tgt)
        if not ok:
            raise UpgradeError(
                f"target {cfg_tgt.name!r} is not servable: {why}")
        limit = cfg_tgt.max_seq_len
        if cfg_tgt.learned_pos:
            limit = min(limit, cfg_tgt.learned_pos)
        if engine.max_len > limit:
            raise UpgradeError(
                f"engine max_len {engine.max_len} exceeds target "
                f"{cfg_tgt.name!r} position range {limit}")
        self._spec_enabled = False
        self.spec_reason: Optional[str] = None
        if speculate_after not in ("auto", True, False):
            raise UpgradeError(
                f"speculate_after must be 'auto', True or False "
                f"(got {speculate_after!r})")
        if speculate_after in ("auto", True):
            ok, why = spec_pair_supported(cfg_tgt, cfg_src, spec_d,
                                          engine.max_len)
            if ok and cfg_src.compute_dtype != cfg_tgt.compute_dtype:
                # the engine keeps one working type for draft and target
                ok, why = False, (
                    f"the draft computes in {cfg_src.compute_dtype} but "
                    f"the target in {cfg_tgt.compute_dtype}")
            if ok:
                self._spec_enabled = True
            elif speculate_after is True:
                raise UpgradeError(
                    f"draft-after-swap pair {cfg_src.name!r} -> "
                    f"{cfg_tgt.name!r} is unsupported: {why}")
            else:
                self.spec_reason = why

        self.engine = engine
        self.cfg_src = cfg_src
        self.cfg_tgt = cfg_tgt
        # the draft is the source AS SERVED NOW: captured before growth,
        # so the post-swap draft is what every mid-flight sequence was
        # decoded with
        self.params_src = engine.params
        self.method = method
        self.rank = rank
        self.grow_steps = grow_steps
        self.data_iter = data_iter
        self.grow_noise = grow_noise
        self.grown_params = grown_params
        self.spec_d = spec_d
        self.upgrade_at = upgrade_at
        self.prewarm = prewarm
        self.probe_fp = probe_fp
        self.seed = seed

        self.state = "serving"
        self.history: List[tuple] = [("serving", time.monotonic())]
        self.error: Optional[BaseException] = None
        self.fp_token_agreement: Optional[float] = None
        self.grow_seconds: Optional[float] = None
        self.prewarm_seconds: Optional[float] = None
        # (group size, prefill bucket) of each prewarm admission
        self.prewarm_shapes: List[tuple] = []
        self.pause_ms: Optional[float] = None
        self.resumed: Optional[int] = None
        self.resumed_requests: List[Request] = []
        # the swap's page bill (paged engines; zeros when dense): pages
        # live at the quiesce are all invalidated (their bytes are the old
        # model's activations), so none is carried, and the resume wave
        # re-prefills ``pages_reprefilled`` pages
        self.pages_resident_at_swap: Optional[int] = None
        self.pages_carried: Optional[int] = None
        self.pages_reprefilled: Optional[int] = None
        self.tokens_at_swap: Optional[int] = None
        self.t_swap: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        engine.upgrade = self

    # ---------------------------------------------------------------- states
    def _set_state(self, state: str) -> None:
        assert state in UPGRADE_STATES, state
        self.state = state
        self.history.append((state, time.monotonic()))

    def spec_config(self) -> Optional[SpeculativeConfig]:
        """The post-swap draft pair (None when draft-after-swap is off)."""
        if not self._spec_enabled:
            return None
        return SpeculativeConfig(self.cfg_src, self.params_src,
                                 d=self.spec_d)

    def disable_spec(self, why: str) -> None:
        """Called by the swap when the draft would break the zero-drop
        guarantee (its page need pushing a resume's shared-arena
        reservation past an explicit page budget)."""
        self._spec_enabled = False
        self.spec_reason = why

    # ----------------------------------------------------------------- growth
    def start(self, background: bool = True) -> "UpgradeManager":
        """Start growth.  ``background=True`` grows on a thread while the
        engine keeps serving the source; ``background=False`` returns
        when ready (deterministic swaps).  A growth failure moves to
        ``failed`` and the engine keeps serving: a bad upgrade never takes
        down live traffic."""
        if self.state != "serving":
            raise UpgradeError(f"start() in state {self.state!r}")
        self._set_state("growing")
        if background:
            self._thread = threading.Thread(target=self._grow, daemon=True)
            self._thread.start()
        else:
            self._grow()
            if self.error is not None:
                raise self.error
        return self

    def _grow(self) -> None:
        t0 = time.monotonic()
        try:
            if self.grown_params is None:
                from repro_torch.core.grow import grow_from_source
                data_iter = self.data_iter
                if self.grow_steps and data_iter is None:
                    from repro_torch.data import lm_data_iter
                    data_iter = lm_data_iter(self.cfg_tgt.vocab_size, 4, 32,
                                             seed=self.seed + 1)
                self.grown_params = grow_from_source(
                    self.cfg_src, self.cfg_tgt, method=self.method,
                    rank=self.rank, steps=self.grow_steps,
                    data_iter=data_iter, params_src=self.params_src,
                    seed=self.seed, noise=self.grow_noise,
                    device=self.engine.device, log_fn=lambda *a, **k: None)
            self.grow_seconds = time.monotonic() - t0
            if self.probe_fp:
                rng = np.random.default_rng(self.seed)
                prompts = rng.integers(
                    0, self.cfg_tgt.vocab_size, size=(4, 8), dtype=np.int32)
                self.fp_token_agreement = probe_token_agreement(
                    self.cfg_src, self.params_src, self.cfg_tgt,
                    self.grown_params, prompts)
            if self.prewarm:
                t1 = time.monotonic()
                self._prewarm()
                self.prewarm_seconds = time.monotonic() - t1
            self._set_state("ready")
        except Exception as e:  # noqa: BLE001 (re-raised by start/wait)
            # a failed growth must not take the serving engine down: it
            # is recorded, and the engine keeps serving the source
            self.error = e
            self._set_state("failed")

    def _prewarm(self) -> None:
        """Run the grown path before the flip.  A scratch engine of the
        exact post-swap geometry admits the reference's scratch traffic:
        for every power-of-two group size up to the capacity (a swap's
        resume wave of ``capacity`` requests pads to that) and every
        prefill bucket, one group of zero prompts with two new tokens, and
        one macro step after it (``step()``; the reference's pipelined
        ``run`` dispatches a second one that changes nothing).  The port's
        macro step is a Python loop of identical steps, so the scratch
        engine runs K = 1: it launches every kernel and library routine of
        K steps in one."""
        eng = self.engine
        scratch = ContinuousBatchingEngine(
            self.cfg_tgt, self.grown_params, capacity=eng.capacity,
            max_len=eng.max_len, prefill_bucket=eng.prefill_bucket,
            k=1, policy=eng.policy, pool=eng._pool_arg,
            pages=eng.pages_arg, sampling=eng.sampling,
            speculative=self.spec_config())
        buckets = sorted({scratch._bucketed(n)
                          for n in range(1, eng.max_len - 1)})
        counts = sorted({min(1 << i, eng.capacity)
                         for i in range(eng.capacity.bit_length() + 1)})
        uid = -1_000_000  # scratch uids never collide with traffic
        for n in counts:
            for b in buckets:
                plen = max(1, min(b, eng.max_len - 2))
                reqs = [Request(uid=uid - i,
                                prompt=np.zeros((plen,), np.int32),
                                max_new_tokens=2) for i in range(n)]
                uid -= n
                self.prewarm_shapes.append((n, b))
                for r in reqs:
                    scratch.submit(r)
                while scratch.waiting or scratch.active:
                    scratch.step()
        scratch.run()  # the last evictions
        if scratch.rejected:
            raise RuntimeError(f"prewarm requests were refused: "
                               f"{scratch.rejected}")

    # ------------------------------------------------------------------ swap
    def poll(self, engine: Optional[ContinuousBatchingEngine] = None
             ) -> bool:
        """Called by the engine at every block boundary.  Returns True
        when it performed the swap."""
        engine = engine or self.engine
        if self.state != "ready":
            return False
        if engine.lifetime_totals()["n_decode_dispatches"] < self.upgrade_at:
            return False
        self._set_state("relayout")
        engine._apply_upgrade(self)
        return True

    def _swapped(self, engine: ContinuousBatchingEngine, pause_ms: float,
                 resumes, *, pages_resident: int = 0,
                 pages_reprefilled: int = 0) -> None:
        """Engine callback at the end of ``_apply_upgrade``."""
        self.pause_ms = pause_ms
        self.resumed = len(resumes)
        self.resumed_requests = list(resumes)
        self.pages_resident_at_swap = int(pages_resident)
        self.pages_carried = 0
        self.pages_reprefilled = int(pages_reprefilled)
        self.tokens_at_swap = engine.lifetime_totals()["n_tokens"]
        self.t_swap = time.monotonic()
        self._set_state("swapped")

    def wait(self) -> "UpgradeManager":
        """Join a background growth; re-raise its failure here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error
        return self
