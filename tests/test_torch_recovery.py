"""The port's request journal, crash recovery and engine snapshots
(``repro_torch/serve/recovery.py`` and the engine's resume contract)
against the JAX package's (CPU, converted weights).

The journal is JAX's format byte for byte: each package writes the same
file for the same records and reads the other's to equal states (torn
tail and repeated crashes included).  A crash is a ``FaultPlan`` crash at
dispatch N in either package: the journal is flushed and the engine raises
``EngineKilled`` before that dispatch launches.  Either package resumes the
other's journal to the uninterrupted run's tokens: greedy exactly, sampled
up to
the near-tie rule of ``_torch_port.check_sampled`` with the resumed
chains bit-equal to JAX's.  Snapshots restore across packages, and a
pre-growth snapshot refuses a post-growth arch by name.
"""
import dataclasses
import filecmp
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_port import both_params, check_sampled, port_config, \
    sampled_replay
from repro.checkpoint.manager import save_checkpoint as jax_save_checkpoint
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import EngineKilled, Fault, FaultPlan
from repro.serve import Request as JaxRequest
from repro.serve import RequestJournal as JaxJournal
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import read_journal as jax_read_journal
from repro.serve import recovery_requests as jax_recovery_requests
from repro.serve import restore_engine as jax_restore_engine
from repro.serve import snapshot_engine as jax_snapshot_engine
from repro_torch.checkpoint import CheckpointShapeError
from repro_torch.convert import from_jax
from repro_torch.serve import EngineKilled as PortEngineKilled
from repro_torch.serve import Fault as PortFault
from repro_torch.serve import FaultPlan as PortFaultPlan
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    RequestJournal,
    SamplingParams,
    SpeculativeConfig,
    read_journal,
    recovery_requests,
    restore_engine,
    snapshot_engine,
)

MAX_LEN = 32
KW = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
SP = dict(temperature=0.9, top_k=12, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def gpt():
    jcfg = jax_get_config("gpt-micro")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_get_config("qwen3-0.6b-smoke")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


def _mixed(make, vocab, specs, *, uid0=0, seed0=50):
    return [make(uid=uid0 + i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _prefix_trace(make, vocab):
    """Six requests opening with one 8-token prefix (two full pages of 4
    at max_len 32), as the reference's paged crash test builds them."""
    prefix = lm_batch(vocab, 1, 8, seed=701)[0]
    return [make(uid=uid, prompt=np.concatenate(
        [prefix, lm_batch(vocab, 1, 2 + uid % 3, seed=900 + uid)[0]]),
        max_new_tokens=5 + uid % 3) for uid in range(6)]


def _perturbed(jp, scale=3e-3, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * rng.standard_normal(a.shape))
                        .astype(a.dtype), jp)


def _case(name, gpt, qwen):
    """(JAX cfg, port cfg, JAX params, port params, JAX engine kwargs,
    port engine kwargs, request maker) of one crash case."""
    if name == "greedy":
        jcfg, cfg, jp, tp = gpt
        specs = [(4, 8), (7, 5), (5, 9), (9, 3), (3, 6)]
        return jcfg, cfg, jp, tp, {}, {}, \
            lambda make: _mixed(make, cfg.vocab_size, specs)
    jcfg, cfg, jp, tp = qwen
    if name == "sampled":
        return jcfg, cfg, jp, tp, dict(sampling=JaxSamplingParams(**SP)), \
            dict(sampling=SamplingParams(**SP)), \
            lambda make: _mixed(make, cfg.vocab_size,
                                [(4, 9), (6, 6), (8, 8), (5, 7)], seed0=80)
    if name == "speculative":
        jd = _perturbed(jp)
        return jcfg, cfg, jp, tp, \
            dict(speculative=JaxSpeculativeConfig(jcfg, jd, d=2), k=2), \
            dict(speculative=SpeculativeConfig(cfg, from_jax(jd), d=2), k=2), \
            lambda make: _mixed(make, cfg.vocab_size,
                                [(4, 8), (7, 5), (5, 7)], seed0=90)
    return jcfg, cfg, jp, tp, dict(pool="paged"), dict(pool="paged"), \
        lambda make: _prefix_trace(make, cfg.vocab_size)


def _jax_crash(jcfg, jp, jreqs, crash, path, **kw):
    """JAX's engine killed by its FaultPlan at dispatch ``crash``, with
    its journal at ``path``."""
    j = JaxJournal(str(path))
    eng = JaxEngine(jcfg, jp, journal=j,
                    faults=FaultPlan([Fault("crash", crash)]), **kw)
    with pytest.raises(EngineKilled):
        eng.run(jreqs)
    j.close()


def _port_crash(cfg, tp, reqs, crash, path, **kw):
    """The port's engine killed by its FaultPlan at dispatch ``crash``,
    with its journal at ``path``."""
    j = RequestJournal(str(path))
    eng = ContinuousBatchingEngine(
        cfg, tp, journal=j, faults=PortFaultPlan([PortFault("crash", crash)]),
        **kw)
    with pytest.raises(PortEngineKilled, match=f"engine step {crash}"):
        eng.run(reqs)
    assert eng.waiting or eng.active
    j.close()


def _same_requests(port_reqs, jax_reqs):
    def key(r):
        return (r.uid, [int(t) for t in r.prompt], r.max_new_tokens,
                r.eos_id, r.deadline, r.n_committed)
    assert [key(r) for r in port_reqs] == [key(r) for r in jax_reqs]


def _check_outputs(name, cfg, tp, reqs, got, want, sp=None):
    assert set(got) == set(want) == {r.uid for r in reqs}
    for r in reqs:
        if sp is None:
            np.testing.assert_array_equal(got[r.uid], want[r.uid],
                                          err_msg=f"{name} uid {r.uid}")
            continue
        drawn, gaps = sampled_replay(cfg, tp, r.prompt, r.uid, sp,
                                     got[r.uid], MAX_LEN)
        check_sampled("resumed vs replay", r.uid, got[r.uid], drawn, gaps)
        check_sampled("resumed vs JAX", r.uid, got[r.uid], want[r.uid], gaps)


# ------------------------------------------------------------- the journal
def _write_records(j, make):
    """Two crash cycles and a rejection, through ``j`` (either package's
    RequestJournal); ``make`` is that package's Request."""
    j.record_submit(make(uid=1, prompt=np.array([5, 6, 7], np.int32),
                         max_new_tokens=6))
    j.record_tokens(1, [10, 11])
    j.record_submit(make(uid=2, prompt=np.array([8, 9], np.int32),
                         max_new_tokens=4, eos_id=21))
    j.record_tokens(2, [20])
    j.record_submit(make(uid=3, prompt=np.array([4], np.int32),
                         max_new_tokens=2))
    j.record_tokens(3, [5, 6])
    j.record_finish(3, "finished")
    j.record_reject(4, "request 4: empty prompt")
    j.flush()
    # crash cycle 2: uid 1 resumes with its run folded into its prompt
    j.record_submit(make(uid=1, prompt=np.array([5, 6, 7, 10, 11], np.int32),
                         max_new_tokens=6, n_committed=2))
    j.record_tokens(1, [12])
    j.record_tokens(2, [21, 22])
    j.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_files_are_byte_equal_and_read_alike(writer, tmp_path):
    """Both packages write the same bytes for the same records; each
    package's reader parses the ``writer``'s file, torn tail included, to
    equal states and equal recovery requests."""
    paths = {}
    for pkg, journal, make in (("jax", JaxJournal, JaxRequest),
                               ("port", RequestJournal, Request)):
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        _write_records(journal(str(paths[pkg])), make)
    assert filecmp.cmp(paths["jax"], paths["port"], shallow=False)
    path = paths[writer]
    with open(path, "a") as f:  # a crash mid-append: half a record
        f.write('{"t": "tok", "uid": 1, "toks": [99')
    got, want = read_journal(str(path)), jax_read_journal(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.committed[1] == [10, 11, 12]  # reset + delta, no 99
    resume, done = recovery_requests(got)
    jresume, jdone = jax_recovery_requests(want)
    _same_requests(resume, jresume)
    assert set(done) == set(jdone) == {2, 3}
    for uid in done:
        np.testing.assert_array_equal(done[uid], jdone[uid])
    np.testing.assert_array_equal(done[2], [20, 21])  # cut at its eos
    (r1,) = resume
    assert r1.uid == 1 and r1.n_committed == 3
    np.testing.assert_array_equal(r1.prompt, [5, 6, 7, 10, 11, 12])


def test_engine_journal_equals_jax_byte_for_byte(gpt, tmp_path):
    """The same greedy trace (slot reuse, an eos, a refused request)
    through both engines writes byte-equal journals, and journaling adds
    no host sync."""
    jcfg, cfg, jp, tp = gpt
    specs = [(4, 8), (7, 5), (5, 9), (9, 3)]

    def reqs(make):
        rs = _mixed(make, cfg.vocab_size, specs)
        rs[1].eos_id = 3
        rs.append(make(uid=9, prompt=np.zeros((0,), np.int32)))
        return rs
    jj = JaxJournal(str(tmp_path / "jax.jsonl"))
    JaxEngine(jcfg, jp, journal=jj, **KW).run(reqs(JaxRequest))
    jj.close()
    pj = RequestJournal(str(tmp_path / "port.jsonl"))
    eng = ContinuousBatchingEngine(cfg, tp, journal=pj, **KW)
    eng.run(reqs(Request))
    pj.close()
    assert filecmp.cmp(tmp_path / "jax.jsonl", tmp_path / "port.jsonl",
                       shallow=False)
    plain = ContinuousBatchingEngine(cfg, tp, **KW)
    plain.run(reqs(Request))
    assert (eng.n_host_syncs, eng.n_decode_dispatches) == (
        plain.n_host_syncs, plain.n_decode_dispatches)


# ------------------------------------------------- JAX crashes, port resumes
@pytest.mark.parametrize("crash", [1, 3])
@pytest.mark.parametrize("name", ["greedy", "sampled", "speculative",
                                  "paged"])
def test_port_resumes_a_jax_crash(name, crash, gpt, qwen, tmp_path):
    """JAX's engine dies at dispatch ``crash``; the port reads JAX's
    journal, resumes every mid-flight request (prompt ‖ committed) and
    finishes the trace with JAX's uninterrupted tokens.  JAX resumes the
    same journal beside it, step for step: equal recovery requests, equal
    admissions, and (sampled) bit-equal chains after every step."""
    jcfg, cfg, jp, tp, jkw, pkw, make = _case(name, gpt, qwen)
    kw = dict(KW)
    kw.update({k: v for k, v in jkw.items() if k == "k"})
    jkw = {k: v for k, v in jkw.items() if k != "k"}
    pkw = {k: v for k, v in pkw.items() if k != "k"}
    want = JaxEngine(jcfg, jp, **kw, **jkw).run(make(JaxRequest))
    path = tmp_path / "j.jsonl"
    _jax_crash(jcfg, jp, make(JaxRequest), crash, path, **kw, **jkw)
    shutil.copy(path, tmp_path / "jax_copy.jsonl")
    resumed, done = recovery_requests(read_journal(str(path)))
    jresumed, jdone = jax_recovery_requests(
        jax_read_journal(str(tmp_path / "jax_copy.jsonl")))
    _same_requests(resumed, jresumed)
    assert set(done) == set(jdone)
    assert any(r.n_committed > 0 for r in resumed)

    j2 = RequestJournal(str(path))
    eng = ContinuousBatchingEngine(cfg, tp, journal=j2, **kw, **pkw)
    jeng = JaxEngine(jcfg, jp, **kw, **jkw)
    for r, jr in zip(resumed, jresumed):
        eng.submit(r)
        jeng.submit(jr)
    while eng.waiting or eng.active:
        eng.step()
        jeng.step()
        assert set(eng.active) == set(jeng.active)
        if name == "sampled":
            assert (eng._keys.numpy()
                    == np.asarray(jeng._state[5]).astype(np.int64)).all()
    assert not (jeng.waiting or jeng.active)
    eng.run()  # applies the last evictions
    j2.close()
    got = {**done, **eng.finished}
    assert eng.n_admitted == len(resumed) == jeng.n_admitted
    if name == "paged":
        # the restart rebuilt its prefix registry and later waves hit it
        assert eng.n_prefix_hits == jeng.n_prefix_hits > 0
        assert eng.pages_in_use == 0
    sp = SamplingParams(**SP) if name == "sampled" else None
    _check_outputs(name, cfg, tp, make(Request), got, want, sp)
    # the resumed journal, read again, holds every request whole
    st = read_journal(str(path))
    assert set(st.finished) == set(want)
    for uid, toks in st.committed.items():
        np.testing.assert_array_equal(toks, got[uid])


def test_port_crashes_twice_and_jax_resumes(gpt, tmp_path):
    """The other direction, through two crash cycles in one file: the port
    dies at dispatch 2, its resume at dispatch 2 again, and JAX's engine
    finishes the trace from the port's journal with its own uninterrupted
    tokens."""
    jcfg, cfg, jp, tp = gpt
    specs = [(4, 8), (7, 5), (5, 9), (9, 3), (3, 6)]
    want = JaxEngine(jcfg, jp, **KW).run(_mixed(JaxRequest, cfg.vocab_size,
                                                specs))
    path = tmp_path / "j.jsonl"
    _port_crash(cfg, tp, _mixed(Request, cfg.vocab_size, specs), 2, path,
                **KW)
    resumed, done = recovery_requests(read_journal(str(path)))
    _port_crash(cfg, tp, resumed, 2, path, **KW)
    jresumed, jdone = jax_recovery_requests(jax_read_journal(str(path)))
    assert any(r.n_committed > 0 for r in jresumed)
    jj = JaxJournal(str(path))
    out = JaxEngine(jcfg, jp, journal=jj, **KW).run(jresumed)
    jj.close()
    got = {**jdone, **out}
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


@pytest.mark.parametrize("crash", [1, 2])
def test_port_crash_resume_is_token_exact(crash, gpt, tmp_path):
    """The port resumes its own crash to its uninterrupted tokens, and the
    resumed sequences really carried committed runs."""
    _, cfg, _, tp = gpt
    specs = [(4, 8), (7, 5), (5, 9), (9, 3), (3, 6)]
    want = ContinuousBatchingEngine(cfg, tp, **KW).run(
        _mixed(Request, cfg.vocab_size, specs))
    path = tmp_path / "j.jsonl"
    _port_crash(cfg, tp, _mixed(Request, cfg.vocab_size, specs), crash,
                path, **KW)
    resumed, done = recovery_requests(read_journal(str(path)))
    assert any(r.n_committed > 0 for r in resumed)
    out = ContinuousBatchingEngine(cfg, tp, **KW).run(resumed)
    got = {**done, **out}
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def test_resume_contract_validation(gpt):
    """``n_committed`` must leave a real prompt token and lie below the
    budget; a resume needs P - nc + max_new positions; a deadline must be
    positive, as in the reference, and a positive one serves."""
    _, cfg, _, tp = gpt
    eng = ContinuousBatchingEngine(cfg, tp, capacity=1, max_len=16)
    p = np.arange(1, 11, dtype=np.int32)
    for uid, kw in enumerate([dict(n_committed=10), dict(n_committed=8),
                              dict(n_committed=-1)]):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=8, **kw))
        assert "n_committed" in eng.rejected[uid]
    # 10 - 4 original + 10 new == 16 positions: admissible
    eng.submit(Request(uid=5, prompt=p, max_new_tokens=10, n_committed=4))
    assert 5 not in eng.rejected
    eng.submit(Request(uid=6, prompt=p, max_new_tokens=11, n_committed=4))
    assert "prompt 6 + 11 new tokens exceeds max_len 16" in eng.rejected[6]
    eng.submit(Request(uid=7, prompt=p, max_new_tokens=4, deadline=0.0))
    assert "deadline must be > 0 (got 0.0)" in eng.rejected[7]
    eng.submit(Request(uid=8, prompt=p, max_new_tokens=4, deadline=1e6))
    assert 8 not in eng.rejected
    out = eng.run()
    assert len(out[5]) == 10 and list(out[5][:4]) == [7, 8, 9, 10]
    assert eng.outcomes[8] == "finished" and len(out[8]) == 4


# ------------------------------------------------------- snapshot/restore
def test_port_snapshot_restores_in_jax_and_back(qwen, tmp_path):
    """A sampled paged port engine's snapshot: JAX's ``restore_engine``
    rebuilds it with the same geometry and sampling, and its tokens equal
    the port engine's; the port restores JAX's snapshot of that engine to
    the same tokens.  The manifest carries JAX's keys."""
    jcfg, cfg, jp, tp = qwen
    sp = SamplingParams(temperature=0.8, top_k=8, seed=3)
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=4, k=4,
              pool="paged", pages=20)
    eng = ContinuousBatchingEngine(cfg, tp, sampling=sp, **kw)
    snapshot_engine(eng, str(tmp_path / "port"), step=5)
    jeng = jax_restore_engine(str(tmp_path / "port"))
    assert (jeng.capacity, jeng.k, jeng.max_len, jeng.pages_arg,
            jeng.pool_kind, jeng.mesh_shape) == (3, 4, MAX_LEN, 20, "paged",
                                                 "1x1")
    assert jeng.sampling == JaxSamplingParams(**dataclasses.asdict(sp))
    specs = [(4, 6), (7, 4), (5, 5)]
    a = eng.run(_mixed(Request, cfg.vocab_size, specs, seed0=60))
    b = jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs, seed0=60))
    _check_outputs("JAX restore", cfg, tp, _mixed(Request, cfg.vocab_size,
                                                  specs, seed0=60), a, b, sp)
    jax_snapshot_engine(jeng, str(tmp_path / "jax"), step=2)
    eng2 = restore_engine(str(tmp_path / "jax"), device="cpu")
    assert (eng2.cfg.name, eng2.pool_kind, eng2.pages_budget,
            eng2.sampling) == (cfg.name, "paged", 20, sp)
    c = eng2.run(_mixed(Request, cfg.vocab_size, specs, seed0=60))
    for uid in a:
        np.testing.assert_array_equal(a[uid], c[uid])
    import json
    with open(tmp_path / "port" / "step_0000000005" / "manifest.json") as f:
        extra = json.load(f)["extra"]
    with open(tmp_path / "jax" / "step_0000000002" / "manifest.json") as f:
        jextra = json.load(f)["extra"]
    assert set(extra) == set(jextra)
    assert extra["decode_kernel"] == "jnp" and extra["mesh_shape"] is None


def test_speculative_snapshot_round_trips_the_draft(qwen, tmp_path):
    """A speculative engine's snapshot holds the draft too; the restored
    engine (either package) drafts with it."""
    jcfg, cfg, jp, tp = qwen
    jd = _perturbed(jp)
    eng = ContinuousBatchingEngine(
        cfg, tp, speculative=SpeculativeConfig(cfg, from_jax(jd), d=2),
        **KW)
    snapshot_engine(eng, str(tmp_path))
    for restore, kw in ((restore_engine, dict(device="cpu")),
                        (jax_restore_engine, {})):
        e = restore(str(tmp_path), **kw)
        assert e.speculative.d == 2 and e.speculative.cfg.name == cfg.name
        leaf = np.asarray(e.speculative.params["embed"])
        np.testing.assert_array_equal(leaf, np.asarray(jd["embed"]))


def test_restore_overrides_and_refusals(gpt, tmp_path):
    _, cfg, _, tp = gpt
    eng = ContinuousBatchingEngine(cfg, tp, **KW)
    snapshot_engine(eng, str(tmp_path / "snap"))
    j = RequestJournal(str(tmp_path / "j.jsonl"))
    eng2 = restore_engine(str(tmp_path / "snap"), device="cpu", journal=j,
                          k=2)
    assert eng2.journal is j and eng2.k == 2
    j.close()
    with pytest.raises(FileNotFoundError):
        restore_engine(str(tmp_path / "empty"), device="cpu")
    jax_save_checkpoint(str(tmp_path / "train"), 1, {"w": np.zeros(2)},
                        extra={"kind": "train"})
    with pytest.raises(ValueError, match="not an engine snapshot"):
        restore_engine(str(tmp_path / "train"), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pre_growth_snapshot_refuses_the_grown_arch(writer, gpt, tmp_path):
    """A gpt-micro snapshot (either package's) restored with
    ``arch="gpt-micro-big"`` raises ``CheckpointShapeError`` naming both
    archs, the group and "pre-growth snapshot" -- the port's message is
    JAX's -- and restores with its own arch."""
    from repro.checkpoint.manager import \
        CheckpointShapeError as JaxShapeError

    jcfg, cfg, jp, tp = gpt
    if writer == "jax":
        jax_snapshot_engine(JaxEngine(jcfg, jp, **KW), str(tmp_path))
    else:
        snapshot_engine(ContinuousBatchingEngine(cfg, tp, **KW),
                        str(tmp_path))
    with pytest.raises(CheckpointShapeError) as port:
        restore_engine(str(tmp_path), arch="gpt-micro-big", device="cpu")
    with pytest.raises(JaxShapeError) as ref:
        jax_restore_engine(str(tmp_path), arch="gpt-micro-big")
    msg = str(port.value)
    assert "'gpt-micro-big'" in msg and "'gpt-micro'" in msg
    assert "pre-growth snapshot" in msg and "group 'params'" in msg
    assert port.value.leaf == ref.value.leaf
    assert msg.split(": leaf")[0] == str(ref.value).split(": leaf")[0]
    assert restore_engine(str(tmp_path), device="cpu").cfg.name == \
        "gpt-micro"


# -------------------------------------------------------- telemetry window
def test_drain_and_lifetime_totals_equal_jax(gpt):
    """The same trace stepped through both engines with a drain midway:
    the drained outputs, the window counters after the drain and
    ``lifetime_totals()`` at the end equal JAX's, and the totals equal an
    undrained engine's counters."""
    jcfg, cfg, jp, tp = gpt
    specs = [(4, 8), (7, 5), (5, 9), (9, 3), (3, 6), (6, 4)]
    eng = ContinuousBatchingEngine(cfg, tp, **KW)
    jeng = JaxEngine(jcfg, jp, **KW)
    for r, jr in zip(_mixed(Request, cfg.vocab_size, specs),
                     _mixed(JaxRequest, cfg.vocab_size, specs)):
        eng.submit(r)
        jeng.submit(jr)
    for _ in range(3):
        eng.step()
        jeng.step()
    got, want = eng.drain(), jeng.drain()
    assert got and set(got) == set(want)
    assert eng.lifetime == jeng.lifetime
    assert eng.lifetime_totals() == jeng.lifetime_totals()
    assert eng.n_tokens == 0 == jeng.n_tokens
    while eng.waiting or eng.active:
        eng.step()
        jeng.step()
    assert eng.lifetime_totals() == jeng.lifetime_totals()
    assert set(eng.finished) | set(got) == set(range(len(specs)))
    whole = ContinuousBatchingEngine(cfg, tp, **KW)
    for r in _mixed(Request, cfg.vocab_size, specs):
        whole.submit(r)
    while whole.waiting or whole.active:
        whole.step()
    assert eng.lifetime_totals() == whole.lifetime_totals()
    assert eng.lifetime_totals()["n_admitted"] == len(specs)
    # drained uids are submittable again
    again = _mixed(Request, cfg.vocab_size, specs)[min(got)]
    eng.submit(again)
    assert eng.waiting[-1] is again
    assert eng.pool is eng._pools[0] and eng.pool_d is None


def test_journal_and_upgrade_poll_add_no_host_sync(gpt, tmp_path):
    """An engine with a journal and an attached, ready upgrade that never
    reaches its dispatch threshold: the same tokens and exactly the host
    syncs of the bare engine."""
    from repro_torch.serve import UpgradeManager

    _, cfg, _, tp = gpt
    specs = [(4, 8), (7, 5), (5, 9), (9, 3)]
    bare = ContinuousBatchingEngine(cfg, tp, **KW)
    want = bare.run(_mixed(Request, cfg.vocab_size, specs))
    j = RequestJournal(str(tmp_path / "j.jsonl"))
    eng = ContinuousBatchingEngine(cfg, tp, journal=j, **KW)
    UpgradeManager(eng, cfg, grown_params=tp, upgrade_at=10**9,
                   prewarm=False, speculate_after=False).start(
                       background=False)
    got = eng.run(_mixed(Request, cfg.vocab_size, specs))
    j.close()
    assert eng.upgrade.state == "ready" and eng.n_upgrades == 0
    assert eng.n_host_syncs == bare.n_host_syncs
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert torch.equal(eng.pool["dense"]["k"], bare.pool["dense"]["k"])
