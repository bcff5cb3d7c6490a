"""The port's continuous-batching engine against the JAX engine and the
port's own ``generate`` on converted weights (CPU): greedy tokens are
exactly equal, for K in {1, 4}, fifo and spf admission, slot reuse, and an
eos that fires inside a macro block.  The engine on the card is tested in
``test_torch_gpu.py``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import both_params, port_config, tiny_gqa
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.launch.serve import generate as jax_generate
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.launch.serve import generate
from repro_torch.configs import get_config
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SpeculativeConfig,
)

MAX_LEN = 32
SPECS = [(3, 6), (9, 2), (5, 8), (12, 4), (4, 7), (7, 1), (6, 5)]


@pytest.fixture(scope="module")
def gpt():
    jcfg = jax_get_config("gpt-micro-big")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


def _requests(make, vocab, specs, seed0=50, eos=None):
    reqs = [make(uid=i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]
    if eos is not None:
        reqs[0].eos_id = eos
    return reqs


def _generate_each(cfg, params, reqs):
    return {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens, max_len=MAX_LEN,
                            eos_id=r.eos_id)[0].numpy() for r in reqs}


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")


@pytest.mark.parametrize("k,policy", [(1, "fifo"), (1, "spf"), (4, "fifo"),
                                      (4, "spf")])
def test_engine_tokens_equal_jax_engine_and_generate(gpt, k, policy):
    jcfg, tcfg, jp, tp = gpt
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=4, k=k,
              policy=policy)
    want_engine = JaxEngine(jcfg, jp, **kw)
    want = want_engine.run(_requests(JaxRequest, jcfg.vocab_size, SPECS))
    eng = ContinuousBatchingEngine(tcfg, tp, **kw)
    reqs = _requests(Request, tcfg.vocab_size, SPECS)
    got = eng.run(reqs)
    _assert_same(got, want)
    _assert_same(got, _generate_each(tcfg, tp, reqs))
    # same admission waves and dispatch pattern as the reference engine
    assert (eng.n_prefills, eng.n_decode_dispatches, eng.n_host_syncs,
            eng.n_tokens) == (want_engine.n_prefills,
                              want_engine.n_decode_dispatches,
                              want_engine.n_host_syncs,
                              want_engine.n_tokens)
    assert len(reqs) > eng.capacity  # slots were reused


def test_eos_mid_block_freezes_the_row(gpt):
    """An eos firing inside a K=4 block truncates the row there; its
    neighbour's tokens are untouched."""
    jcfg, tcfg, jp, tp = gpt
    specs = [(6, 12), (8, 12)]
    base = _generate_each(tcfg, tp, _requests(Request, tcfg.vocab_size,
                                              specs, seed0=31))
    eos, stop = next((int(base[0][i]), i + 1) for i in range(1, 3)
                     if int(np.argmax(base[0] == base[0][i])) == i)
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
    got = ContinuousBatchingEngine(tcfg, tp, **kw).run(
        _requests(Request, tcfg.vocab_size, specs, seed0=31, eos=eos))
    want = JaxEngine(jcfg, jp, **kw).run(
        _requests(JaxRequest, jcfg.vocab_size, specs, seed0=31, eos=eos))
    _assert_same(got, want)
    np.testing.assert_array_equal(got[0], base[0][:stop])
    np.testing.assert_array_equal(got[1], base[1])
    assert 1 < stop < 4


def test_gqa_engine_and_generate_with_eos_match_jax():
    jcfg = tiny_gqa()
    jp, tp = both_params(jcfg)
    tcfg = port_config(jcfg)
    specs = [(5, 6), (11, 3), (7, 7)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
    want = JaxEngine(jcfg, jp, **kw).run(
        _requests(JaxRequest, jcfg.vocab_size, specs))
    got = ContinuousBatchingEngine(tcfg, tp, **kw).run(
        _requests(Request, tcfg.vocab_size, specs))
    _assert_same(got, want)
    prompts = lm_batch(jcfg.vocab_size, 2, 6, seed=3)
    eos = int(want[0][2])
    jg = np.asarray(jax_generate(jcfg, jp, jax.numpy.asarray(prompts),
                                 max_new_tokens=8, eos_id=eos))
    tg = generate(tcfg, tp, torch.from_numpy(prompts), max_new_tokens=8,
                  eos_id=eos).numpy()
    np.testing.assert_array_equal(tg, jg)


def test_rejections_are_recorded_and_serving_continues(gpt):
    _, tcfg, _, tp = gpt
    eng = ContinuousBatchingEngine(tcfg, tp, capacity=1, max_len=MAX_LEN)
    V = tcfg.vocab_size
    bads = [
        (Request(uid=0, prompt=np.zeros(MAX_LEN, np.int32),
                 max_new_tokens=4), "exceeds max_len"),
        (Request(uid=1, prompt=np.zeros((0,), np.int32), max_new_tokens=4),
         "empty prompt"),
        (Request(uid=2, prompt=np.zeros(4, np.int32), max_new_tokens=0),
         "max_new_tokens"),
        (Request(uid=3, prompt=np.zeros(4, np.int32), max_new_tokens=2,
                 eos_id=V), "eos_id"),
        (Request(uid=4, prompt=np.full(4, V, np.int32), max_new_tokens=2),
         "outside the vocabulary"),
    ]
    for req, why in bads:
        eng.submit(req)
        assert why in eng.rejected[req.uid], req.uid
        assert eng.outcomes[req.uid] == "rejected"
        assert not eng.waiting and req.uid not in eng._seen_uids
    got = eng.run([Request(uid=7, prompt=np.zeros(4, np.int32),
                           max_new_tokens=2)])
    assert set(got) == {7} and len(got[7]) == 2
    with pytest.raises(ValueError, match="already submitted"):
        eng.submit(Request(uid=7, prompt=np.zeros(4, np.int32)))


@pytest.mark.parametrize("kw", [
    # the paged pool is ported; load shedding is not
    dict(shed_age=1.0), dict(sampling=object()),
    # speculation is ported, sampled speculation is not
    dict(speculative=SpeculativeConfig(get_config("gpt-micro"), {}, d=2),
         sampling=object()),
    dict(deadline=1.0), dict(journal=object()), dict(faults=object()),
    dict(mesh="1x1")])
def test_unported_engine_modes_raise(gpt, kw):
    _, tcfg, _, tp = gpt
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousBatchingEngine(tcfg, tp, max_len=MAX_LEN, **kw)


def test_engine_refuses_bad_geometry(gpt):
    _, tcfg, _, tp = gpt
    with pytest.raises(ValueError, match="position range"):
        ContinuousBatchingEngine(tcfg, tp, max_len=tcfg.learned_pos + 1)
    with pytest.raises(ValueError, match="macro-step"):
        ContinuousBatchingEngine(tcfg, tp, max_len=MAX_LEN, k=0)
    with pytest.raises(ValueError, match="policy"):
        ContinuousBatchingEngine(tcfg, tp, max_len=MAX_LEN, policy="lifo")


def test_step_admits_by_arrival_not_submission_order(gpt):
    """``step(now)`` admits the requests that have arrived by ``now``: a
    later-submitted but earlier-arriving request does not queue behind an
    unarrived one."""
    _, tcfg, _, tp = gpt
    late, early = _requests(Request, tcfg.vocab_size, [(4, 3), (5, 6)],
                            seed0=20)
    late.arrival, early.arrival = 5.0, 0.1
    eng = ContinuousBatchingEngine(tcfg, tp, capacity=2, max_len=MAX_LEN,
                                   prefill_bucket=4, k=1)
    eng.submit(late)
    eng.submit(early)
    eng.step(now=0.2)
    assert [s.req.uid for s in eng.active.values()] == [early.uid]
    eng.step(now=6.0)
    assert {s.req.uid for s in eng.active.values()} == {late.uid, early.uid}
    while eng.waiting or eng.active:
        eng.step(now=7.0)
    _assert_same(eng.finished, _generate_each(tcfg, tp, [late, early]))
