"""Crash-safe request journal, and engine snapshot and restore.

A sequence is a pure function of (params, prompt, committed tokens,
per-request sampling chain): greedy decode is deterministic, and a
sampled request's chain position equals its generated-token count.  So
recovery needs no device state: journal WHAT was committed, and a
restarted engine re-derives the rest by prefilling ``prompt ‖ committed``
through the ordinary admission path (a ``Request`` with ``n_committed``).

Journal format (the reference package's, byte for byte)
-------------------------------------------------------
Append-only JSONL, one record a line:

    {"t": "submit", "uid", "prompt": [...], "max_new_tokens",
     "eos_id", "n_committed", "deadline"}
    {"t": "tok", "uid", "toks": [...]}     # committed-token delta
    {"t": "fin", "uid", "outcome"}         # finished / quarantined / ...
    {"t": "rej", "uid", "why"}             # submit() refused it

Records are buffered and flushed ONLY where the engine already waits on
the device (the admission readback and the block readback), so
journaling adds no host sync.  The reader tolerates a torn tail (a crash
mid-write leaves at most one unparseable last line) and keeps the last
submit of each uid: a resumed request re-submits with its committed run
folded into ``prompt`` and counted by ``n_committed``, so one journal
file survives any number of crash and restart cycles.  Either package
reads the other's journal.

Token-exactness: greedy and sampled macro decode resume token for token
(a chain advances once a token).  Speculative SAMPLED decode advances a
chain once a speculative block, not once a token, so its resume keeps
the distribution but is not replay-exact; greedy speculative decode
consumes no chain and resumes exactly.

Snapshot and restore
--------------------
``snapshot_engine`` writes the weights (target, and the draft in
speculative mode) through ``checkpoint/manager.py``'s atomic, CRC-checked
format with the engine's geometry in the manifest's ``extra`` (the
reference's keys; the reference-only ``decode_kernel`` is written as its
default ``"jnp"`` and ``mesh_shape`` as None); ``restore_engine`` rebuilds
an equivalent engine from the snapshot alone.  Each package restores the
other's snapshots.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import (
    CheckpointShapeError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.serve.engine import ContinuousBatchingEngine, Request
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.speculative import SpeculativeConfig
from repro_torch.utils.device import resolve_device


class RequestJournal:
    """Append-only journal of request lifecycle events.

    Writes are buffered in memory; the engine calls ``flush()`` only where
    it already waits on a device readback.  ``fsync=True`` also fsyncs
    every flush (crash safety against power loss, at ~ms a block; the
    default relies on the OS page cache, which survives a killed
    process)."""

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._buf: List[str] = []

    # ------------------------------------------------------------- records
    def record_submit(self, req: Request) -> None:
        self._buf.append(json.dumps({
            "t": "submit", "uid": int(req.uid),
            "prompt": [int(x) for x in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "n_committed": int(req.n_committed),
            "deadline": req.deadline,
        }))

    def record_tokens(self, uid: int, toks) -> None:
        if len(toks):
            self._buf.append(json.dumps(
                {"t": "tok", "uid": int(uid),
                 "toks": [int(t) for t in toks]}))

    def record_finish(self, uid: int, outcome: str) -> None:
        self._buf.append(json.dumps(
            {"t": "fin", "uid": int(uid), "outcome": outcome}))

    def record_reject(self, uid: int, why: str) -> None:
        self._buf.append(json.dumps(
            {"t": "rej", "uid": int(uid), "why": why}))

    # ------------------------------------------------------------- plumbing
    def flush(self) -> None:
        if not self._buf:
            return
        self._f.write("\n".join(self._buf) + "\n")
        self._buf.clear()
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self.flush()
        self._f.close()


@dataclasses.dataclass
class JournalState:
    """What a journal file says."""
    submits: Dict[int, dict]          # uid -> latest submit record
    committed: Dict[int, List[int]]   # uid -> all committed tokens so far
    finished: Dict[int, str]          # uid -> outcome (terminal records)
    order: List[int]                  # uids in (first-)submission order


def read_journal(path: str) -> JournalState:
    """Replay a journal.  A torn tail (a crash mid-append) ends the replay
    at the last complete record; a ``submit`` record RESETS the uid's
    committed run to the record's own ``n_committed`` suffix (the last
    submit wins: a resumed submit folds every earlier run's tokens into
    its prompt)."""
    st = JournalState({}, {}, {}, [])
    if not os.path.exists(path):
        return st
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail: nothing after it was committed
            uid = rec.get("uid")
            t = rec.get("t")
            if t == "submit":
                if uid not in st.submits:
                    st.order.append(uid)
                st.submits[uid] = rec
                nc = int(rec.get("n_committed", 0))
                st.committed[uid] = list(
                    rec["prompt"][len(rec["prompt"]) - nc:]) if nc else []
                st.finished.pop(uid, None)
            elif t == "tok":
                st.committed.setdefault(uid, []).extend(rec["toks"])
            elif t == "fin":
                st.finished[uid] = rec["outcome"]
            elif t == "rej":
                st.finished[uid] = "rejected"
    return st


def recovery_requests(st: JournalState
                      ) -> Tuple[List[Request], Dict[int, np.ndarray]]:
    """(requests to re-admit, outputs already complete) of a replayed
    journal.

    A mid-flight uid becomes a resume request: the original prompt
    followed by its committed tokens, ``n_committed`` marking them, so
    the engine's ordinary prefill derives the next token exactly.  A uid
    whose committed run already fills its budget or fired its eos needs
    no slot and comes back as finished output (its fin record died with
    the crash, its tokens did not)."""
    resume: List[Request] = []
    done: Dict[int, np.ndarray] = {}
    for uid in st.order:
        if uid in st.finished:
            if st.finished[uid] == "finished" and st.committed.get(uid):
                done[uid] = np.asarray(st.committed[uid], np.int32)
            continue
        rec = st.submits[uid]
        toks = st.committed.get(uid, [])
        budget = int(rec["max_new_tokens"])
        eos = rec.get("eos_id")
        fired = next((i for i, t in enumerate(toks) if t == eos),
                     None) if eos is not None else None
        if fired is not None:
            done[uid] = np.asarray(toks[:fired + 1], np.int32)
            continue
        if len(toks) >= budget:
            done[uid] = np.asarray(toks[:budget], np.int32)
            continue
        nc0 = int(rec.get("n_committed", 0))
        orig = rec["prompt"][:len(rec["prompt"]) - nc0] if nc0 \
            else rec["prompt"]
        resume.append(Request(
            uid=uid,
            prompt=np.asarray(list(orig) + toks, np.int32),
            max_new_tokens=budget,
            eos_id=eos,
            deadline=rec.get("deadline"),
            n_committed=len(toks)))
    return resume, done


# ------------------------------------------------------------ snapshot/restore
def snapshot_engine(engine: ContinuousBatchingEngine, ckpt_dir: str,
                    step: int = 0) -> str:
    """Write what rebuilds an equivalent engine: the weights (target, and
    the draft in speculative mode) and the engine's geometry.  The
    checkpoint format is atomic, so a crash mid-snapshot never corrupts
    an earlier one.  Returns the step's directory."""
    tree = {"params": engine.params}
    if engine.speculative is not None:
        tree["draft"] = engine.speculative.params
    sp = engine.sampling
    extra = {
        "kind": "serve_engine",
        "arch": engine.cfg.name,
        # the reference's TPU kernel switch, at its default (the port's
        # device picks kernel or plain version)
        "decode_kernel": "jnp",
        "capacity": engine.capacity,
        "max_len": engine.max_len,
        "prefill_bucket": engine.prefill_bucket,
        "k": engine.k,
        "policy": engine.policy,
        "pool": "paged" if engine._metas[0] is not None else "dense",
        "pages": engine.pages_arg,
        "mesh_shape": None,  # meshes are not ported: one device
        "sampling": None if sp is None else dataclasses.asdict(sp),
        "draft_arch": (None if engine.speculative is None
                       else engine.speculative.cfg.name),
        "spec_d": (None if engine.speculative is None
                   else engine.speculative.d),
        "deadline": engine.deadline,
    }
    return save_checkpoint(ckpt_dir, step, tree, extra)


def _template(cfg, device):
    """Empty params of ``cfg``'s shapes and dtypes on ``device`` (the
    restore template; shapes come from an init on the meta device)."""
    from repro_torch.models import get_family
    from repro_torch.utils.pytree import tree_map

    shapes = get_family(cfg).init(torch.Generator().manual_seed(0), cfg,
                                  device="meta")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), shapes)


def restore_engine(ckpt_dir: str, step: Optional[int] = None,
                   arch: Optional[str] = None,
                   draft_arch: Optional[str] = None, *, device="cuda",
                   **overrides) -> ContinuousBatchingEngine:
    """Rebuild an engine from ``snapshot_engine``'s output (either
    package's) on ``device`` (CUDA unless asked for the CPU).  Keyword
    overrides (``journal=...``) pass through to the constructor: a
    restart typically reattaches the journal the dead engine wrote.

    ``arch`` / ``draft_arch`` override the recorded architectures (an
    engine whose model was swapped after the snapshot).  Weights on disk
    that do not fit the requested geometry raise a named
    ``CheckpointShapeError`` that identifies the group."""
    from repro_torch.configs import get_config

    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no engine snapshot in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        extra = json.load(f)["extra"]
    if extra.get("kind") != "serve_engine":
        raise ValueError(f"{d} is not an engine snapshot")
    dev = resolve_device(device)
    arch_name = arch or extra["arch"]
    cfg = get_config(arch_name)
    template = {"params": _template(cfg, dev)}
    cfg_d = None
    d_arch = draft_arch if draft_arch is not None else \
        extra.get("draft_arch")
    if d_arch:
        cfg_d = get_config(d_arch)
        template["draft"] = _template(cfg_d, dev)
    try:
        tree, _, _ = load_checkpoint(ckpt_dir, template, step)
    except CheckpointShapeError as e:
        group = (e.leaf or "?").split(".", 1)[0]
        want = arch_name if group == "params" else d_arch
        have = extra["arch"] if group == "params" \
            else extra.get("draft_arch")
        raise CheckpointShapeError(
            f"engine snapshot step {step} in {ckpt_dir} holds "
            f"{have!r} weights in group {group!r} but the restore "
            f"requests {want!r} — a pre-growth snapshot cannot restore "
            f"into a post-growth engine (snapshot again after the swap, "
            f"or pass the matching arch=): {e}", leaf=e.leaf) from e
    del template
    sampling = None
    if extra.get("sampling"):
        sampling = SamplingParams(**extra["sampling"])
    speculative = None
    if cfg_d is not None:
        speculative = SpeculativeConfig(cfg_d, tree["draft"],
                                        d=int(extra["spec_d"]))
    # a saved mesh is a placement preference, not a requirement (the
    # reference restores single-device when it no longer fits); meshes
    # are not ported, so every restore is single-device
    kw = dict(capacity=extra["capacity"], max_len=extra["max_len"],
              prefill_bucket=extra["prefill_bucket"], k=extra["k"],
              policy=extra["policy"], pool=extra["pool"],
              pages=extra.get("pages"), sampling=sampling,
              speculative=speculative, deadline=extra.get("deadline"))
    kw.update(overrides)
    return ContinuousBatchingEngine(cfg, tree["params"], **kw)
