"""The port's fault layer (``repro_torch/serve/faults.py`` and the engine's
deadlines, shedding, quarantine, arena degradation and fault injection)
against the JAX package's (CPU, converted weights).

Both engines run the same trace under the same ``FaultPlan``: outcomes,
the fault counters, the surviving tokens and the journal's bytes are held
equal, and the survivors equal the plain run.  Plans are equal schedules in
both packages (numpy's PCG64), and a plan crash in either package resumes
in the other to the uninterrupted tokens.  Deadlines, the per-request
override, shedding and ``run(realtime=True)`` run on a fake clock whose
sleep advances it -- the port's through ``serve.faults._monotonic`` /
``_sleep``, JAX's by replacing its engine module's ``time`` -- so they do
not depend on how fast the machine computes.
"""
import dataclasses
import filecmp
import importlib
import shutil
import types

import jax
import numpy as np
import pytest

from _torch_port import both_params, port_config
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import EngineKilled as JaxEngineKilled
from repro.serve import Fault as JaxFault
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import Request as JaxRequest
from repro.serve import RequestJournal as JaxJournal
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import faults as jax_faults
from repro.serve import read_journal as jax_read_journal
from repro.serve import recovery_requests as jax_recovery_requests
from repro.serve import restore_engine as jax_restore_engine
from repro.serve import snapshot_engine as jax_snapshot_engine
from repro_torch.convert import from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    ContinuousBatchingEngine,
    EngineKilled,
    Fault,
    FaultPlan,
    Request,
    RequestJournal,
    SpeculativeConfig,
    read_journal,
    recovery_requests,
    restore_engine,
    snapshot_engine,
)
from repro_torch.serve import faults as faults_lib

MAX_LEN = 32
KW = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
# the counters the fault layer moves, beside the ones every run moves
COUNTERS = ("n_quarantined", "n_expired", "n_shed", "n_faults_injected",
            "n_degraded_admissions", "n_spec_fallbacks", "n_admitted",
            "n_tokens", "n_prefills", "n_decode_dispatches", "n_host_syncs",
            "n_pages_allocated", "n_prefix_hits", "n_spec_proposed",
            "n_spec_accepted")


@pytest.fixture(scope="module")
def qwen():
    """The reference's fault-test subject, qwen1.5-0.5b-smoke."""
    jcfg = jax_get_config("qwen1.5-0.5b-smoke")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


class FakeClock:
    """Seconds that move only when something sleeps on them."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += max(float(s), 0.0)


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock for the port's engine and one for JAX's."""
    port, ref = FakeClock(), FakeClock()
    monkeypatch.setattr(faults_lib, "_monotonic", port.monotonic)
    monkeypatch.setattr(faults_lib, "_sleep", port.sleep)
    jax_engine_mod = importlib.import_module("repro.serve.engine")
    monkeypatch.setattr(jax_engine_mod, "time", types.SimpleNamespace(
        monotonic=ref.monotonic, perf_counter=ref.monotonic,
        sleep=ref.sleep))
    return port, ref


def _mixed(make, vocab, specs, *, uid0=0, seed0=50):
    return [make(uid=uid0 + i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _plans(spec):
    """The same plan in both packages: a parse string, or Fault tuples."""
    if isinstance(spec, str):
        return FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    return (FaultPlan([Fault(*f) for f in spec]),
            JaxFaultPlan([JaxFault(*f) for f in spec]))


def _both(model, specs, plan, tmp_path, *, seed0, jkw=None, pkw=None,
          **kw):
    """Run ``specs`` through both engines under ``plan`` with a journal
    each; return (port engine, JAX engine, port out, JAX out)."""
    jcfg, cfg, jp, tp = model
    kw = dict(KW, **kw)
    pplan, jplan = _plans(plan)
    jj = JaxJournal(str(tmp_path / "jax.jsonl"))
    jeng = JaxEngine(jcfg, jp, journal=jj, faults=jplan, **kw, **(jkw or {}))
    want = jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs, seed0=seed0))
    jj.close()
    pj = RequestJournal(str(tmp_path / "port.jsonl"))
    eng = ContinuousBatchingEngine(cfg, tp, journal=pj, faults=pplan, **kw,
                                   **(pkw or {}))
    got = eng.run(_mixed(Request, cfg.vocab_size, specs, seed0=seed0))
    pj.close()
    return eng, jeng, got, want


def _assert_like_jax(eng, jeng, got, want, tmp_path):
    """Outcomes, counters, every delivered token and the journal bytes
    equal JAX's."""
    assert eng.outcomes == jeng.outcomes
    assert {c: getattr(eng, c) for c in COUNTERS} == {
        c: getattr(jeng, c) for c in COUNTERS}
    assert eng.rejected == jeng.rejected
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")
    assert filecmp.cmp(tmp_path / "jax.jsonl", tmp_path / "port.jsonl",
                       shallow=False)


def _plain(model, specs, seed0, **kw):
    _, cfg, _, tp = model
    return ContinuousBatchingEngine(cfg, tp, **dict(KW, **kw)).run(
        _mixed(Request, cfg.vocab_size, specs, seed0=seed0))


def _survivors_exact(eng, got, plain):
    """Every request that finished equals the fault-free run; a
    quarantined one delivered a strict prefix of it."""
    for uid, toks in plain.items():
        if eng.outcomes[uid] == "finished":
            np.testing.assert_array_equal(got[uid], toks,
                                          err_msg=f"uid {uid}")
        elif eng.outcomes[uid] == "quarantined":
            assert len(got[uid]) < len(toks)
            np.testing.assert_array_equal(got[uid], toks[:len(got[uid])])


# ------------------------------------------------------------------- plans
def test_fault_plan_parse_and_delivery_match_jax():
    spec = "nan@3:1,oom@5:2,slow@7:0.1,crash@9,hang@4,malformed@2"
    plan, jplan = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    assert [dataclasses.astuple(f) for f in plan.faults] == [
        dataclasses.astuple(f) for f in jplan.faults]
    assert plan.faults[1].kind == "nan" and plan.faults[1].slot == 1
    assert FaultPlan.parse("slow@1").faults[0].duration == 0.05
    assert FaultPlan.parse("hang@1").faults[0].duration == 0.25
    assert FaultPlan.parse("oom@1").faults[0].duration == 2.0
    assert len(FaultPlan.parse("  ")) == 0
    for bad, match in (("meteor@3", "kind"), ("nan3", "not 'kind@step")):
        with pytest.raises(ValueError, match=match):
            FaultPlan.parse(bad)
        with pytest.raises(ValueError, match=match):
            JaxFaultPlan.parse(bad)
    # at-most-once delivery: due() pops, a second call returns nothing
    plan = FaultPlan([Fault("slow", 5, duration=0.01), Fault("nan", 2)])
    assert [f.kind for f in plan.due(3)] == ["nan"]
    assert plan.due(3) == [] and len(plan.injected) == 1
    assert [f.kind for f in plan.due(99)] == ["slow"] and len(plan) == 0


@pytest.mark.parametrize("seed,n_steps,kw", [
    (0, 32, {}), (11, 24, {}), (12, 24, {}), (7, 3, {}),
    (3, 12, dict(kinds=("nan", "oom", "slow", "malformed"), n_faults=3,
                 slow_s=0.01)),
    (5, 40, dict(n_faults=9, hang_s=1.5, oom_waves=3))])
def test_seeded_plans_equal_jax(seed, n_steps, kw):
    """``seeded`` draws from numpy's PCG64 in the reference's order: the
    same schedule in both packages, and ``parse('seed:S:N')`` with it."""
    got = FaultPlan.seeded(seed, n_steps, **kw).faults
    want = JaxFaultPlan.seeded(seed, n_steps, **kw).faults
    assert [dataclasses.astuple(f) for f in got] == [
        dataclasses.astuple(f) for f in want]
    assert all(1 <= f.step < max(n_steps, 2) for f in got)
    if not kw:
        assert [dataclasses.astuple(f) for f in
                FaultPlan.parse(f"seed:{seed}:{n_steps}").faults] == [
            dataclasses.astuple(f) for f in want]


@pytest.mark.parametrize("arch,pool", [("gpt-micro", "dense"),
                                       ("griffin-micro", "dense"),
                                       ("griffin-micro", "paged")])
def test_poison_pool_matches_jax(arch, pool):
    """NaN lands where JAX's lands: a dense float leaf's slot row in every
    layer, a paged group's page ``pid`` of k and v in every layer, never an
    integer leaf (block tables); the port writes in place."""
    jcfg = jax_get_config(arch)
    cfg = port_config(jcfg)
    jp, tp = both_params(jcfg)
    kw = dict(capacity=3, max_len=MAX_LEN, pool=pool)
    jpool = JaxEngine(jcfg, jp, **kw)._pools[0]
    eng = ContinuousBatchingEngine(cfg, tp, **kw)
    ptr = {g: {n: t.data_ptr() for n, t in grp.items()}
           for g, grp in eng.pool.items()}
    out = faults_lib.poison_pool(eng.pool, 1, 2)
    assert out is eng.pool
    jout = jax_faults.poison_pool(jpool, 1, 2)
    n_nan = 0
    for g, grp in out.items():
        for name, t in grp.items():
            assert t.data_ptr() == ptr[g][name]  # in place
            want = np.asarray(jout[g][name])
            got = t.numpy()
            if "bt" in grp and name != "bt":
                got = got[:, :want.shape[1]]  # the scratch page aside
            if want.dtype.kind == "f":
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
                n_nan += int(np.isnan(got).sum())
            else:
                np.testing.assert_array_equal(got, want)
    assert n_nan > 0


# --------------------------------------------------------------- quarantine
def test_nan_quarantines_only_poisoned_slot(qwen, tmp_path):
    """NaN in slot 0's live cache: that request alone retires as
    ``quarantined`` with a prefix of its tokens; every other request is
    token-exact; outcomes, counters, tokens and journal equal JAX's."""
    specs = [(4, 9), (6, 7), (5, 8), (7, 6)]
    eng, jeng, got, want = _both(qwen, specs, [("nan", 2, 0)], tmp_path,
                                 seed0=30)
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    assert eng.n_quarantined == 1 and eng.n_faults_injected == 1
    assert list(eng.outcomes.values()).count("quarantined") == 1
    _survivors_exact(eng, got, _plain(qwen, specs, 30))


def test_oom_slow_malformed_are_absorbed(qwen, clocks, tmp_path):
    """oom stalls admission waves (requests wait, none lost), slow costs
    clock time only, a hostile mid-trace request lands in ``rejected``;
    every real request is token-exact, as in JAX."""
    specs = [(4, 7), (6, 5), (5, 6), (7, 4), (3, 5), (8, 6)]
    eng, jeng, got, want = _both(qwen, specs, "oom@1:1,slow@2:0.01,"
                                 "malformed@3", tmp_path, seed0=40)
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    assert eng.n_faults_injected == 3 and eng._oom_waves == 0
    assert [u for u in eng.rejected] == [-1003]
    assert "empty prompt" in eng.rejected[-1003]
    plain = _plain(qwen, specs, 40)
    assert all(eng.outcomes[u] == "finished" for u in plain)
    _survivors_exact(eng, got, plain)
    port_clock, jax_clock = clocks
    assert port_clock.t == jax_clock.t == pytest.approx(0.01)


def test_draft_nan_falls_back_to_plain_decode(qwen, tmp_path):
    """A draft-pool NaN costs no token: the engine demotes to the plain
    target loop once and stays there; the target rows are never bad."""
    jcfg, cfg, jp, tp = qwen
    rng = np.random.default_rng(1)
    jd = jax.tree.map(lambda a: (a + 3e-3 * rng.standard_normal(a.shape))
                      .astype(a.dtype), jp)
    specs = [(4, 8), (6, 6), (5, 7), (7, 5)]
    eng, jeng, got, want = _both(
        qwen, specs, [("nan", 2, 0, 1)], tmp_path, seed0=90, k=2,
        jkw=dict(speculative=JaxSpeculativeConfig(jcfg, jd, d=2)),
        pkw=dict(speculative=SpeculativeConfig(cfg, from_jax(jd), d=2)))
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    assert eng.n_spec_fallbacks == 1 and eng._spec_fallback
    assert eng.n_quarantined == 0
    _survivors_exact(eng, got, _plain(qwen, specs, 90, k=2))


def test_paged_arena_degrades_after_quarantine(qwen, tmp_path):
    """A NaN in a paged arena: quarantine flushes the prefix registry and
    every later admission reserves its full block table; no page is left
    in use, and JAX's engine counts the same."""
    specs = [(4, 8), (6, 6), (5, 7), (7, 5), (4, 6), (6, 5)]
    eng, jeng, got, want = _both(qwen, specs, [("nan", 2, 0)], tmp_path,
                                 seed0=100, pool="paged")
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    assert eng.n_quarantined == 1 and eng._arena_degraded
    assert eng.n_degraded_admissions > 0 and not eng._prefix_ok
    assert eng.pages_in_use == jeng.pages_in_use == 0
    _survivors_exact(eng, got, _plain(qwen, specs, 100, pool="paged"))


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_chaos_survivors_match_jax(seed, qwen, clocks, tmp_path):
    """A seeded chaos plan (no crash): every request is accounted for, the
    finished ones are token-exact, and both packages agree on all of it."""
    kinds = ("nan", "oom", "slow", "malformed")
    specs = [(4, 8), (6, 6), (5, 9), (7, 5), (3, 7), (8, 6), (5, 5), (6, 8)]
    jcfg, cfg, jp, tp = qwen
    kw = dict(KW, capacity=3)
    plan = FaultPlan.seeded(seed, 12, kinds=kinds, n_faults=3, slow_s=0.01)
    jplan = JaxFaultPlan.seeded(seed, 12, kinds=kinds, n_faults=3,
                                slow_s=0.01)
    jj = JaxJournal(str(tmp_path / "jax.jsonl"))
    jeng = JaxEngine(jcfg, jp, journal=jj, faults=jplan, **kw)
    want = jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs, seed0=110))
    jj.close()
    pj = RequestJournal(str(tmp_path / "port.jsonl"))
    eng = ContinuousBatchingEngine(cfg, tp, journal=pj, faults=plan, **kw)
    got = eng.run(_mixed(Request, cfg.vocab_size, specs, seed0=110))
    pj.close()
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    assert eng.n_faults_injected == 3
    plain = ContinuousBatchingEngine(cfg, tp, **kw).run(
        _mixed(Request, cfg.vocab_size, specs, seed0=110))
    assert all(eng.outcomes[u] in ("finished", "quarantined") for u in plain)
    _survivors_exact(eng, got, plain)


# -------------------------------------------------------------- deadlines
def test_deadline_expires_hung_requests_on_a_fake_clock(qwen, clocks,
                                                        tmp_path):
    """A hang longer than the deadline: at the next step boundary every
    request is expired -- the active ones with their partial tokens, the
    queued one with an empty output -- and serving stops, as in JAX."""
    specs = [(4, 20), (6, 20), (5, 20)]
    eng, jeng, got, want = _both(qwen, specs, [("hang", 2, -1, 0, 0.4)],
                                 tmp_path, seed0=60, k=2, deadline=0.12)
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    assert eng.n_expired == 3 and set(got) == {0, 1, 2}
    assert set(eng.outcomes.values()) == {"expired"}
    assert len(got[2]) == 0 and 0 < len(got[0]) < 20
    assert eng.n_decode_dispatches == 2  # bounded: no 20-token serving
    assert clocks[0].t == pytest.approx(0.4)


def test_per_request_deadline_overrides_engine_default(qwen, clocks,
                                                       tmp_path):
    jcfg, cfg, jp, tp = qwen

    def reqs(make):
        rs = _mixed(make, cfg.vocab_size, [(4, 12), (6, 4)], seed0=70)
        rs[0].deadline = 0.05  # tighter than the engine's default
        return rs
    kw = dict(KW, k=2, deadline=60.0)
    jeng = JaxEngine(jcfg, jp, faults=JaxFaultPlan([JaxFault(
        "slow", 2, duration=0.1)]), **kw)
    jeng.run(reqs(JaxRequest))
    eng = ContinuousBatchingEngine(cfg, tp, faults=FaultPlan([Fault(
        "slow", 2, duration=0.1)]), **kw)
    eng.run(reqs(Request))
    assert eng.outcomes == jeng.outcomes == {0: "expired", 1: "finished"}
    assert eng.n_expired == jeng.n_expired == 1


def test_shed_by_queue_age_on_a_fake_clock(qwen, clocks, tmp_path):
    """Behind a slow dispatch, queued requests older than ``shed_age`` are
    shed: told why, their uids free for a retry; JAX sheds the same.  A
    retry is served in the port; JAX keeps the shed request's submit time
    and sheds the retry at once (a reference fault the port repairs)."""
    specs = [(4, 6)] * 6
    eng, jeng, got, want = _both(qwen, specs, [("slow", 1, -1, 0, 0.2)],
                                 tmp_path, seed0=80, capacity=1, k=2,
                                 shed_age=0.05)
    _assert_like_jax(eng, jeng, got, want, tmp_path)
    shed = [u for u, o in eng.outcomes.items() if o == "shed"]
    assert eng.n_shed == len(shed) > 0
    assert all("shed after" in eng.rejected[u] for u in shed)
    assert not any(u in eng._seen_uids for u in shed)
    # a shed uid may come back (the journals are closed)
    eng.journal = jeng.journal = None
    retry = dict(uid=shed[0], prompt=np.arange(1, 5, dtype=np.int32),
                 max_new_tokens=2)
    eng.submit(Request(**retry))
    assert len(eng.run()[shed[0]]) == 2
    assert eng.outcomes[shed[0]] == "finished"
    jeng.submit(JaxRequest(**retry))
    assert jeng.run() == {} and jeng.outcomes[shed[0]] == "shed"


@pytest.mark.parametrize("pipeline", [True, False])
def test_realtime_run_admits_in_jax_order(pipeline, qwen, clocks):
    """``run(realtime=True)`` replays arrival offsets against the clock:
    an idle engine sleeps to the next arrival, a busy one admits what has
    arrived at each block boundary.  On the fake clock (slow faults move
    it while busy) admissions, first-token and retirement times and
    tokens equal JAX's, pipelined or step by step."""
    jcfg, cfg, jp, tp = qwen
    specs = [(4, 6), (6, 9), (5, 4), (7, 6), (3, 5)]
    arrivals = [0.0, 0.01, 0.03, 0.2, 0.9]
    plan = "slow@1:0.02,slow@3:0.05,slow@6:0.02"

    def reqs(make):
        rs = _mixed(make, cfg.vocab_size, specs, seed0=120)
        for r, a in zip(rs, arrivals):
            r.arrival = a
        return rs
    kw = dict(KW, k=2)
    pplan, jplan = _plans(plan)
    jeng = JaxEngine(jcfg, jp, faults=jplan, **kw)
    want = jeng.run(reqs(JaxRequest), realtime=True, pipeline=pipeline)
    eng = ContinuousBatchingEngine(cfg, tp, faults=pplan, **kw)
    got = eng.run(reqs(Request), realtime=True, pipeline=pipeline)

    def timeline(e):
        return [(s.req.uid, s.slot, s.t_first, s.t_done) for s in e.retired]
    assert timeline(eng) == timeline(jeng)
    assert {c: getattr(eng, c) for c in COUNTERS} == {
        c: getattr(jeng, c) for c in COUNTERS}
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    # the last request arrived while the engine was idle: it waited for it
    last = next(s for s in eng.retired if s.req.uid == 4)
    assert last.t_first == pytest.approx(0.9)
    assert clocks[0].t == clocks[1].t >= 0.9


def test_held_submit_keeps_its_submit_time(qwen, clocks):
    """A submit held across a swap keeps the time it arrived, so its
    deadline counts the held window (JAX's ``setdefault``)."""
    _, cfg, _, tp = qwen
    eng = ContinuousBatchingEngine(cfg, tp, deadline=1.0, **KW)
    port_clock = clocks[0]
    eng.upgrade_state = "relayout"
    eng.submit(Request(uid=3, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=4))
    port_clock.sleep(0.7)
    eng.upgrade_state = "swapped"
    held, eng._held_for_upgrade = eng._held_for_upgrade, []
    for r in held:
        eng._submit_checked(r)
    assert eng._t_submit[3] == 0.0
    port_clock.sleep(0.5)
    eng.step()
    assert eng.outcomes[3] == "expired" and eng.n_expired == 1


# ------------------------------------------------------------ crash, resume
@pytest.mark.parametrize("crasher", ["port", "jax"])
def test_plan_crash_resumes_across_packages(crasher, qwen, tmp_path):
    """One package's engine dies by a ``crash`` fault at dispatch 3 with
    its journal flushed (both write the same bytes); the other package
    resumes the journal to the uninterrupted run's tokens."""
    jcfg, cfg, jp, tp = qwen
    specs = [(4, 8), (7, 5), (5, 9), (9, 3), (3, 6)]
    want = ContinuousBatchingEngine(cfg, tp, **KW).run(
        _mixed(Request, cfg.vocab_size, specs))
    paths = {}
    for pkg in ("port", "jax"):
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        if pkg == "port":
            j = RequestJournal(str(paths[pkg]))
            eng = ContinuousBatchingEngine(
                cfg, tp, journal=j, faults=FaultPlan([Fault("crash", 3)]),
                **KW)
            with pytest.raises(EngineKilled, match="engine step 3"):
                eng.run(_mixed(Request, cfg.vocab_size, specs))
        else:
            j = JaxJournal(str(paths[pkg]))
            jeng = JaxEngine(jcfg, jp, journal=j, faults=JaxFaultPlan(
                [JaxFault("crash", 3)]), **KW)
            with pytest.raises(JaxEngineKilled):
                jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs))
        j.close()
    assert eng.n_faults_injected == jeng.n_faults_injected == 1
    assert filecmp.cmp(paths["port"], paths["jax"], shallow=False)
    path = paths[crasher]
    if crasher == "port":
        resumed, done = jax_recovery_requests(jax_read_journal(str(path)))
        assert any(r.n_committed > 0 for r in resumed)
        out = JaxEngine(jcfg, jp, **KW).run(resumed)
    else:
        resumed, done = recovery_requests(read_journal(str(path)))
        assert any(r.n_committed > 0 for r in resumed)
        out = ContinuousBatchingEngine(cfg, tp, **KW).run(resumed)
    got = {**done, **out}
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")


def test_snapshot_with_a_deadline_restores_both_ways(qwen, tmp_path):
    """An engine with a deadline snapshots and restores (its own package's
    and the other's), the deadline kept."""
    jcfg, cfg, jp, tp = qwen
    eng = ContinuousBatchingEngine(cfg, tp, deadline=2.5, **KW)
    snapshot_engine(eng, str(tmp_path / "port"))
    jeng = JaxEngine(jcfg, jp, deadline=2.5, **KW)
    jax_snapshot_engine(jeng, str(tmp_path / "jax"))
    for d in ("port", "jax"):
        shutil.copytree(tmp_path / d, tmp_path / f"{d}_copy")
        assert restore_engine(str(tmp_path / d), device="cpu").deadline == 2.5
        assert jax_restore_engine(str(tmp_path / f"{d}_copy")).deadline \
            == 2.5


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("argv,want", [
    (["--faults", "nan@2,oom@3:1,slow@4:0.01,malformed@5"],
     "fault report: 4 fault(s) injected, 0 expired, 1 quarantined"),
    (["--deadline", "1000"], "served 4 requests / 32 tokens"),
    (["--faults", "crash@2", "--journal", "J"], "ENGINE KILLED"),
])
def test_fault_flags_run_on_cpu(argv, want, tmp_path, capsys):
    """``--faults`` and ``--deadline`` reach the engine; a crash exits
    cleanly and leaves a journal that ``--resume`` finishes."""
    argv = [str(tmp_path / "j.jsonl") if a == "J" else a for a in argv]
    base = ["--arch", "gpt-micro", "--engine", "continuous", "--batch",
            "4", "--prompt-len", "12", "--gen", "8", "--capacity", "2",
            "--k", "2", "--device", "cpu"]
    launch_serve.main(base + argv)
    out = capsys.readouterr().out
    assert want in out
    if "crash@2" in argv:
        launch_serve.main(base + ["--journal", str(tmp_path / "j.jsonl"),
                                  "--resume"])
        out = capsys.readouterr().out
        assert "re-admitting mid-flight" in out
        assert "served 4 requests / 32 tokens" in out
    with pytest.raises(SystemExit, match="require --engine continuous"):
        launch_serve.main(["--arch", "gpt-micro", "--device", "cpu", *argv])
