"""Deterministic fault injection for the continuous-batching engine.

Fault tolerance that has never seen a fault is a hypothesis.  This module
turns the failure modes the engine claims to survive into a seeded,
replayable schedule -- a :class:`FaultPlan` -- that the engine consults at
one point (``_dispatch``; an ``oom`` then stalls ``_admit_batch``) behind a
``None`` default, so the fault-free path does no extra work.

Fault kinds
-----------
``nan``        Write NaN into the target (or draft: ``pool=1``) slot pool's
               device bytes, in place -- the corruption then flows through
               attention into logits, where the in-loop sentinels must
               catch it.  Not a mocked logit.
``oom``        Page-allocator exhaustion: admission waves stall for
               ``duration`` engine steps (requests stay queued), the
               backpressure path a full arena produces.
``slow``       The next dispatch is delayed by ``duration`` seconds on the
               host -- a straggler device or a contended runtime.
``hang``       ``slow`` with a long default (deadline watchdogs must fire
               while the engine is stuck).
``malformed``  A hostile request (empty prompt) is submitted mid-trace; the
               rejection path must absorb it.
``crash``      The engine flushes its journal and raises
               :class:`EngineKilled` BEFORE dispatch ``step`` launches --
               kill -9 semantics: committed tokens are journaled, everything
               in flight is lost, recovery must re-admit.

Determinism: a plan is a sorted list of ``(kind, step, ...)`` records;
``FaultPlan.seeded`` draws one from numpy's PCG64, so the same (seed,
n_steps, kinds, n_faults) always yields the same schedule, the reference
package's schedule included.

Every clock read and sleep of the engine and of this module goes through
``_monotonic`` and ``_sleep`` below, so a test can put a fake clock in
their place (one whose sleep advances it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

KINDS = ("nan", "oom", "slow", "hang", "malformed", "crash")

# the engine's clock (module attributes, so a test can replace the pair)
_monotonic = time.monotonic
_sleep = time.sleep


def monotonic() -> float:
    """Seconds on the engine's clock."""
    return _monotonic()


def sleep(seconds: float) -> None:
    """Sleep on the engine's clock."""
    _sleep(seconds)


class EngineKilled(RuntimeError):
    """Raised by a ``crash`` fault: the process dying at a step boundary.
    State already journaled survives; in-flight device blocks do not --
    the contract a real SIGKILL leaves."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``step`` counts engine dispatches (the engine's ``_fault_step``);
    ``slot`` pins a nan fault to a slot (-1 = lowest active slot at
    injection time); ``pool`` picks the poisoned pool (0 = target, 1 =
    draft); ``duration`` is seconds for slow/hang, admission waves for oom.
    """
    kind: str
    step: int
    slot: int = -1
    pool: int = 0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {KINDS})")


class FaultPlan:
    """A deterministic schedule of faults, consumed by engine step."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = sorted(faults or [], key=lambda f: f.step)
        self.injected: List[Fault] = []  # consumed, in firing order

    def __len__(self):
        return len(self.faults)

    def due(self, step: int) -> List[Fault]:
        """Pop every fault scheduled at or before ``step`` (at-most-once
        delivery: a consumed fault never fires again, even after the
        engine restarts with the same plan object)."""
        out = []
        while self.faults and self.faults[0].step <= step:
            out.append(self.faults.pop(0))
        self.injected.extend(out)
        return out

    # ------------------------------------------------------------ builders
    @classmethod
    def seeded(cls, seed: int, n_steps: int, *, kinds=KINDS,
               n_faults: int = 4, slow_s: float = 0.05,
               hang_s: float = 0.25, oom_waves: int = 2) -> "FaultPlan":
        """A reproducible random plan: ``n_faults`` draws over ``kinds`` at
        distinct steps in ``[1, n_steps)``.  Same (seed, n_steps, kinds,
        n_faults) -> same schedule, always."""
        rng = np.random.default_rng(seed)
        n_faults = min(n_faults, max(n_steps - 1, 1))
        steps = sorted(rng.choice(np.arange(1, max(n_steps, 2)),
                                  size=n_faults, replace=False).tolist())
        faults = []
        for s in steps:
            kind = kinds[int(rng.integers(len(kinds)))]
            dur = {"slow": slow_s, "hang": hang_s,
                   "oom": float(oom_waves)}.get(kind, 0.0)
            faults.append(Fault(kind=kind, step=int(s), duration=dur))
        return cls(faults)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a CLI plan: comma-separated ``kind@step[:arg]`` items, e.g.
        ``nan@3,oom@5:2,slow@7:0.1,crash@9``.  ``arg`` is the duration
        (seconds for slow/hang, waves for oom) or the slot for nan.
        ``seed:S[:N]`` delegates to :meth:`seeded`."""
        spec = spec.strip()
        if not spec:
            return cls([])
        if spec.startswith("seed:"):
            parts = spec.split(":")
            seed = int(parts[1])
            n_steps = int(parts[2]) if len(parts) > 2 else 32
            return cls.seeded(seed, n_steps)
        faults = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            head, _, arg = item.partition(":")
            kind, _, step = head.partition("@")
            if not step:
                raise ValueError(
                    f"fault item {item!r} is not 'kind@step[:arg]'")
            kw = {"kind": kind.strip(), "step": int(step)}
            if arg:
                if kw["kind"] == "nan":
                    kw["slot"] = int(arg)
                else:
                    kw["duration"] = float(arg)
            elif kw["kind"] == "slow":
                kw["duration"] = 0.05
            elif kw["kind"] == "hang":
                kw["duration"] = 0.25
            elif kw["kind"] == "oom":
                kw["duration"] = 2.0
            faults.append(Fault(**kw))
        return cls(faults)


# ---------------------------------------------------------------- injection
def poison_pool(pool, slot: int, pid: int):
    """Write NaN into one slot's live cache bytes, in place.

    Paged groups poison page ``pid`` of ``k`` and ``v`` in every layer (the
    slot's first block-table page: every decode step's attention reads it,
    so the NaN surfaces in the row's logits within one step).  Dense float
    leaves poison the slot's whole row.  Integer leaves (block tables,
    counters) are untouched -- the fault model is corrupted VALUES, not
    corrupted indices.  Returns ``pool``.

    A paged group without ``k`` (xlstm's slot groups: conv tails and
    carries) raises ``KeyError('k')``, as the reference's does: its
    ``poison_pool`` assumes every paged group is attention K/V.
    """
    for grp in pool.values():
        if "bt" in grp:
            for key in ("k", "v"):
                grp[key][:, pid] = float("nan")
            continue
        for leaf in grp.values():
            if leaf.is_floating_point():
                leaf[:, slot] = float("nan")
    return pool
