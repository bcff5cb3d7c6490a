"""The port's sampling (``repro_torch/serve/sampling.py``) against JAX's
(CPU).

Keys, random bits and uniforms are bit-equal to the installed jax's
threefry (tested against JAX itself, not a written spec); Gumbel noise,
``filtered_probs`` and ``residual_probs`` agree within 1e-6.  Then the
sampled paths on converted weights: the admission prefill with skipped
splits, the macro-step's chains, the engine on qwen3-0.6b-smoke (dense,
paged, with prefix hits, and with rejection-sampled speculation), a
sampled griffin-micro engine, and the serve launcher's flags.  Tokens
equal JAX's and a sequential replay's, except where two Gumbel-perturbed
scores nearly tie (``_torch_port.check_sampled``): the floating-point
steps after the uniforms differ from XLA's in the last bits.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    both_params,
    check_sampled,
    perturbed_scores,
    port_config,
    sampled_replay,
    top2_gap,
)
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.models import get_family as jax_family
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import sampling as jsampling
from repro.train import steps as jsteps
from repro_torch.convert import from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_family
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
    SpeculativeConfig,
)
from repro_torch.serve import sampling
from repro_torch.train import steps

MAX_LEN = 32
V_GPT2 = 50257  # gpt-base's vocabulary


def _key(a):
    """A JAX uint32 key batch as the port's int64 key tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(a):
    return np.asarray(a).astype(np.int64)


def _jax_sp(sp):
    return JaxSamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                             top_p=sp.top_p, seed=sp.seed)


# ------------------------------------------------- bit-equal PRNG (§ keys)
@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 - 1])
def test_request_key_bit_equal_to_jax(seed):
    uids = [0, 1, 12345]
    for uid in uids:
        want = _bits(jsampling.request_key(seed, uid))
        assert (sampling.request_key(seed, uid).numpy() == want).all(), uid
    batched = sampling.request_key(seed, torch.tensor(uids))
    want = _bits(jax.vmap(lambda u: jsampling.request_key(seed, u))(
        jnp.asarray(uids)))
    assert batched.dtype == torch.int64
    assert (batched.numpy() == want).all()
    assert (sampling.prng_key(seed).numpy()
            == _bits(jax.random.PRNGKey(seed))).all()


def _chain_batch(n=6, seed=5):
    return jax.vmap(lambda u: jsampling.request_key(seed, u))(
        jnp.arange(n) * 7 + 3)


def test_next_keys_and_split_bit_equal_to_jax():
    keys = _chain_batch()
    carry, sub = jsampling.next_keys(keys)
    got_c, got_s = sampling.next_keys(_key(keys))
    assert (got_c.numpy() == _bits(carry)).all()
    assert (got_s.numpy() == _bits(sub)).all()
    # a chain advanced three times, and a 5-way split
    k_j, k_t = keys, _key(keys)
    for _ in range(3):
        k_j, _ = jsampling.next_keys(k_j)
        k_t, _ = sampling.next_keys(k_t)
    assert (k_t.numpy() == _bits(k_j)).all()
    want = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    assert (sampling.split(_key(keys), 5).numpy() == _bits(want)).all()


def test_fold_in_bit_equal_to_jax():
    """fold_in for every counter a speculative block of depth d uses
    (draft draws 0..d-1, the uniforms d, the replacements d + 1), and a
    per-row counter tensor."""
    d = 4
    keys = _chain_batch()
    for c in range(d + 2):
        want = jax.vmap(lambda k: jax.random.fold_in(k, c))(keys)
        assert (sampling.fold_in(_key(keys), c).numpy() == _bits(want)).all()
    cs = np.arange(6) * 1000 + 1
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(cs))
    got = sampling.fold_in(_key(keys), torch.from_numpy(cs))
    assert (got.numpy() == _bits(want)).all()
    assert (sampling.fold_in(_key(jax.random.PRNGKey(7)), 5).numpy()
            == [3583082021, 1947592014]).all()


@pytest.mark.parametrize("shape", [(V_GPT2,), (3,), (5, 37)])
def test_random_bits_and_uniforms_bit_equal_to_jax(shape):
    key = jsampling.request_key(11, 4)
    assert (sampling.random_bits(_key(key), shape).numpy()
            == _bits(jax.random.bits(key, shape))).all()
    want = np.asarray(jax.random.uniform(key, shape))
    got = sampling.uniform(_key(key), shape).numpy()
    assert got.dtype == np.float32
    assert (got.view(np.int32) == want.view(np.int32)).all()
    # batched over a key axis, as ``vmap`` batches the reference
    keys = _chain_batch(3)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    got = sampling.uniform(_key(keys), shape).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()


# ----------------------------------------------------- within 1e-6 of JAX
def test_gumbel_within_1e6_of_jax():
    """The Gumbel noise ``-log(-log u)`` from bit-equal uniforms: the inner
    ``-log u`` agrees within 1e-6 relative (log differs by an ulp), and
    the noise within 1e-6 relative to ``1 + |g|``.  An elementwise
    relative bound does not hold where ``g`` crosses 0 (``-log u`` near
    1): there both logs' last bits dominate."""
    key = jsampling.request_key(3, 9)
    shape = (4, V_GPT2)
    want = np.asarray(jax.random.gumbel(key, shape))
    got = sampling.gumbel(_key(key), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    u = sampling.uniform(_key(key), shape, sampling._TINY_F32, 1.0)
    np.testing.assert_allclose(
        (-torch.log(u)).numpy(),
        np.asarray(-jnp.log(jax.random.uniform(
            key, shape, minval=np.finfo(np.float32).tiny))), rtol=1e-6)


def _logits(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("sp,shape", [
    (SamplingParams(temperature=0.8, top_k=12, top_p=0.9), (4, V_GPT2)),
    (SamplingParams(temperature=1.3, top_k=50), (4, V_GPT2)),
    (SamplingParams(temperature=1.0, top_p=0.5), (4, 33))])
def test_filtered_probs_within_1e6_of_jax(sp, shape):
    lg = _logits(shape, 0)
    want = np.asarray(jsampling.filtered_probs(jnp.asarray(lg), _jax_sp(sp)))
    got = sampling.filtered_probs(torch.from_numpy(lg), sp).numpy()
    assert ((got > 0) == (want > 0)).all()  # the same support
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_residual_probs_within_1e6_of_jax():
    sp = SamplingParams(temperature=0.9, top_k=40)
    p = sampling.filtered_probs(torch.from_numpy(_logits((6, 300), 1)), sp)
    q = sampling.filtered_probs(torch.from_numpy(_logits((6, 300), 2)), sp)
    q[0] = p[0]  # a degenerate row falls back to p
    want = np.asarray(jsampling.residual_probs(jnp.asarray(p.numpy()),
                                               jnp.asarray(q.numpy())))
    got = sampling.residual_probs(p, q).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_sampled_tokens_equal_jax_up_to_near_ties():
    """``sample_logits`` over gpt-base-wide rows: tokens equal JAX's, but
    where the perturbed scores' top-2 gap is below ``NEAR_TIE``."""
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    lg = _logits((16, V_GPT2), 3)
    keys = _chain_batch(16, seed=21)
    want = np.asarray(jsampling.sample_logits(jnp.asarray(lg), keys,
                                              _jax_sp(sp)))
    lt = torch.from_numpy(lg)
    got = sampling.sample_logits(lt, _key(keys), sp).numpy()
    gaps = top2_gap(perturbed_scores(lt, _key(keys), sp))
    for b in range(16):
        check_sampled("sample_logits", b, got[b:b + 1], want[b:b + 1],
                      gaps[b:b + 1])
    # greedy consumes no randomness
    assert (sampling.sample_logits(lt, None, SamplingParams()).numpy()
            == lg.argmax(-1)).all()


# ------------------------------------ ports of tests/test_sampling.py units
def test_filtered_probs_top_k():
    logits = torch.from_numpy(_logits((3, 17), 0, 1.0))
    probs = sampling.filtered_probs(
        logits, SamplingParams(temperature=1.0, top_k=5)).numpy()
    assert probs.shape == (3, 17)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert int((probs > 0).sum(-1).max()) <= 5
    # the argmax always survives filtering
    assert (np.take_along_axis(probs, logits.argmax(-1).numpy()[:, None],
                               1) > 0).all()


def test_filtered_probs_top_p():
    logits = torch.from_numpy(_logits((4, 33), 1))
    full = torch.softmax(logits, -1).numpy()
    probs = sampling.filtered_probs(
        logits, SamplingParams(temperature=1.0, top_p=0.5)).numpy()
    kept = probs > 0
    # the kept set is the smallest head of the sorted distribution whose
    # exclusive cumulative mass is < p
    for b in range(4):
        mass = float(full[b][kept[b]].sum())
        assert mass >= 0.5
        if kept[b].sum() > 1:
            assert mass - full[b][kept[b]].min() < 0.5
    sp0 = SamplingParams()
    assert sp0.greedy and sampling.is_greedy(sp0) and sampling.is_greedy(None)


def test_sampling_params_validation():
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-2)


def test_residual_probs_construction():
    p = torch.tensor([[0.5, 0.3, 0.2], [0.25, 0.25, 0.5]])
    q = torch.tensor([[0.2, 0.5, 0.3], [0.25, 0.25, 0.5]])
    r = sampling.residual_probs(p, q).numpy()
    np.testing.assert_allclose(r[0], [1.0, 0.0, 0.0], atol=1e-6)
    # p == q degenerates: falls back to p (acceptance is certain anyway)
    np.testing.assert_allclose(r[1], p[1].numpy(), atol=1e-6)


# ------------------------------------------------------- the step builders
@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_get_config("qwen3-0.6b-smoke")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


def _prompts(vocab, plens, bucket, seed0):
    padded = np.zeros((len(plens), bucket), np.int32)
    for i, p in enumerate(plens):
        padded[i, :p] = lm_batch(vocab, 1, p, seed=seed0 + i)[0]
    return padded, np.asarray(plens, np.int32)


def _admitted(qwen, sp, plens, uids, skips, bucket=16):
    """Both packages' sampled admission prefill of the same prompts:
    ((first, cache, keys) from JAX, the same from the port)."""
    jcfg, cfg, jp, tp = qwen
    padded, pl = _prompts(cfg.vocab_size, plens, bucket, 60)
    n = len(plens)
    jfn = jax.jit(jsteps.make_prefill_admit_step(jcfg, _jax_sp(sp)))
    want = jfn(jp, jnp.asarray(padded), jnp.asarray(pl),
               jax_family(jcfg).init_cache(jcfg, n, MAX_LEN),
               jnp.asarray(uids, jnp.int32), jnp.asarray(skips, jnp.int32))
    got = steps.make_prefill_admit_step(cfg, sp)(
        tp, torch.from_numpy(padded), torch.from_numpy(pl),
        get_family(cfg).init_cache(cfg, n, MAX_LEN), torch.tensor(uids),
        torch.tensor(skips))
    return want, got, padded, pl


def test_prefill_admit_step_with_skips_matches_jax(qwen):
    """Rows whose chains skip 0, 1, 3 and 7 splits (a resumed sequence's
    committed tokens): the advanced chains are bit-equal to JAX's
    ``prefill_sampled``, and each first token is the draw of the chain
    after ``skips`` advances (equal to JAX's up to near ties)."""
    jcfg, cfg, jp, tp = qwen
    sp = SamplingParams(temperature=0.8, top_k=12, top_p=0.9, seed=5)
    uids, skips = [3, 14, 15, 92], [0, 1, 3, 7]
    (jfirst, _, jkeys), (first, _, keys), padded, pl = _admitted(
        qwen, sp, [5, 12, 9, 16], uids, skips)
    assert (keys.numpy() == _bits(jkeys)).all()
    logits, _ = get_family(cfg).prefill_last(
        tp, torch.from_numpy(padded), torch.from_numpy(pl), cfg,
        get_family(cfg).init_cache(cfg, len(uids), MAX_LEN))
    for i, (uid, s) in enumerate(zip(uids, skips)):
        chain = sampling.request_key(sp.seed, torch.tensor([uid]))
        for _ in range(s):
            chain, _ = sampling.next_keys(chain)
        carry, sub = sampling.next_keys(chain)
        assert torch.equal(carry[0], keys[i])
        scores = perturbed_scores(logits[i:i + 1], sub, sp)
        assert int(scores.argmax()) == int(first[i])
        check_sampled("prefill", uid, first[i:i + 1].numpy(),
                      np.asarray(jfirst)[i:i + 1], top2_gap(scores))


def test_sampled_slot_decode_loop_advances_live_chains_like_jax(qwen):
    """Six sampled steps over three admitted rows owing 6, 2 and 0 more
    tokens: the blocks equal JAX's ``loop_sampled`` (near ties aside) and
    each chain is bit-equal to JAX's, advanced once per token its row
    really sampled (6, 2 and 0 times)."""
    jcfg, cfg, jp, tp = qwen
    sp = SamplingParams(temperature=1.1, top_k=0, top_p=0.9, seed=2)
    uids = [4, 5, 6]
    (jfirst, jcache, jkeys), (first, cache, keys), padded, pl = _admitted(
        qwen, sp, [7, 11, 4], uids, [0, 0, 0])
    rem = np.asarray([6, 2, 0], np.int32)
    eos = np.full((3,), -1, np.int32)
    done = rem <= 0
    jloop = jax.jit(jsteps.make_slot_decode_loop(jcfg, 6, _jax_sp(sp)))
    jout = jloop(jp, jfirst, jnp.asarray(pl), jnp.asarray(rem),
                 jnp.asarray(eos), jnp.asarray(done), jcache, jkeys)
    out = steps.make_slot_decode_loop(cfg, 6, sp)(
        tp, first, torch.from_numpy(pl), torch.from_numpy(rem),
        torch.from_numpy(eos), torch.from_numpy(done), cache, keys)
    assert len(out) == len(jout) == 9
    assert (out[-1].numpy() == _bits(jout[-1])).all()
    assert (out[1].numpy() == np.asarray(jout[1])).all()  # valid masks
    root = sampling.request_key(sp.seed, torch.tensor(uids))
    for b, n in enumerate([7, 3, 1]):  # first token + the row's decodes
        chain = root[b:b + 1]
        for _ in range(n):
            chain, _ = sampling.next_keys(chain)
        assert torch.equal(chain[0], out[-1][b])
        toks = np.concatenate([[int(first[b])],
                               out[0][:, b][out[1][:, b]].numpy()])
        jtoks = np.concatenate([[int(jfirst[b])], np.asarray(
            jout[0])[:, b][np.asarray(jout[1])[:, b]]])
        drawn, gaps = sampled_replay(cfg, tp, padded[b, :pl[b]], uids[b],
                                     sp, toks, MAX_LEN)
        check_sampled("loop vs replay", uids[b], toks, drawn, gaps)
        check_sampled("loop vs JAX", uids[b], toks, jtoks, gaps)


# --------------------------------------------------------------- the engine
def _mixed(make, vocab, specs, *, uid0=0, seed0=50):
    return [make(uid=uid0 + i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _check_against_replay_and_jax(cfg, params, reqs, got, want, sp,
                                  max_len=MAX_LEN):
    """Every request: the engine's tokens equal the sequential replay's
    and JAX's, near ties aside (gaps along the engine's own prefix)."""
    assert set(got) == set(want) == {r.uid for r in reqs}
    for r in reqs:
        drawn, gaps = sampled_replay(cfg, params, r.prompt, r.uid, sp,
                                     got[r.uid], max_len)
        check_sampled("engine vs replay", r.uid, got[r.uid], drawn, gaps)
        check_sampled("engine vs JAX", r.uid, got[r.uid], want[r.uid], gaps)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_sampled_engine_matches_replay_and_jax(qwen, pool):
    """Three requests through two slots (recycling): tokens equal the
    sequential replay's and JAX's engine's; the schedule, and so every
    host sync, is the greedy engine's; the sampled trace differs from the
    greedy one."""
    jcfg, cfg, jp, tp = qwen
    sp = SamplingParams(temperature=0.8, top_k=12, top_p=0.9, seed=5)
    specs = [(3, 7), (9, 3), (5, 8)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4, pool=pool,
              pages=16 if pool == "paged" else None)
    jeng = JaxEngine(jcfg, jp, sampling=_jax_sp(sp), **kw)
    want = jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs))
    eng = ContinuousBatchingEngine(cfg, tp, sampling=sp, **kw)
    reqs = _mixed(Request, cfg.vocab_size, specs)
    got = eng.run(reqs)
    _check_against_replay_and_jax(cfg, tp, reqs, got, want, sp)
    greedy = ContinuousBatchingEngine(cfg, tp, **kw)
    got_g = greedy.run(_mixed(Request, cfg.vocab_size, specs))
    assert any(not np.array_equal(got[u], got_g[u]) for u in got)
    counters = ("n_host_syncs", "n_prefills", "n_decode_dispatches",
                "n_tokens")
    assert ({c: getattr(eng, c) for c in counters}
            == {c: getattr(greedy, c) for c in counters}
            == {c: getattr(jeng, c) for c in counters})
    assert not eng._keys.any()  # every slot evicted, every chain zeroed


def test_sampled_interleaving_independence(qwen):
    """Same requests, reversed submission and another macro length: every
    request's sampled tokens are identical (chains are keyed by uid, not
    by slot or step parity)."""
    _, cfg, _, tp = qwen
    sp = SamplingParams(temperature=1.2, top_k=0, top_p=0.95, seed=9)
    reqs = _mixed(Request, cfg.vocab_size, [(4, 6), (8, 5), (6, 7)],
                  seed0=30)
    got1 = ContinuousBatchingEngine(
        cfg, tp, capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4,
        sampling=sp).run(reqs)
    got2 = ContinuousBatchingEngine(
        cfg, tp, capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2,
        sampling=sp).run([Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens)
                          for r in reversed(reqs)])
    for uid in got1:
        np.testing.assert_array_equal(got1[uid], got2[uid],
                                      err_msg=f"uid {uid}")


def test_sampled_prefix_hit_chain_exact_replay(qwen):
    """A sampled prefix hit derives its chain on the device and advances
    it once, at its last tail step, as the skipped prefill would have: a
    hit emits the tokens a miss would (paged == dense, both == JAX's
    paged engine), with hits, fewer prefills than dense, distinct outputs
    for identical prompts and no page in use at the end."""
    jcfg, cfg, jp, tp = qwen
    sp = SamplingParams(temperature=0.9, top_k=12, seed=11)
    prompt = lm_batch(cfg.vocab_size, 1, 19, seed=820)[0]

    def reqs(make, uid0=0):
        return [make(uid=uid0 + i, prompt=prompt.copy(), max_new_tokens=6)
                for i in range(6)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
    paged = ContinuousBatchingEngine(cfg, tp, pool="paged", pages=16,
                                     sampling=sp, **kw)
    got_p = paged.run(reqs(Request))
    assert paged.n_prefix_hits > 0 and paged.prefix_hit_rate > 0
    assert paged.pages_in_use == 0
    dense = ContinuousBatchingEngine(cfg, tp, pool="dense", sampling=sp,
                                     **kw)
    got_d = dense.run(reqs(Request))
    assert paged.n_prefills < dense.n_prefills
    assert len({tuple(v.tolist()) for v in got_p.values()}) > 1
    jeng = JaxEngine(jcfg, jp, pool="paged", pages=16, sampling=_jax_sp(sp),
                     **kw)
    want = jeng.run(reqs(JaxRequest))
    assert (paged.n_prefix_hits, paged.n_prefills) == (jeng.n_prefix_hits,
                                                       jeng.n_prefills)
    r_list = reqs(Request)
    _check_against_replay_and_jax(cfg, tp, r_list, got_p, want, sp)
    _check_against_replay_and_jax(cfg, tp, r_list, got_d, want, sp)


# ------------------------------------------- speculative rejection sampling
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_spec_rejection_sampling_self_draft(qwen, pool):
    """draft == target under sampling: ``min(1, p/q) == 1``, so every
    proposal is accepted; two runs are identical, tokens equal JAX's
    speculative engine's and differ from greedy speculation's."""
    jcfg, cfg, jp, tp = qwen
    sp = SamplingParams(temperature=0.9, top_k=16, seed=11)
    specs = [(3, 8), (7, 6), (5, 9)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2, pool=pool)

    def run(sampled=True):
        e = ContinuousBatchingEngine(
            cfg, tp, sampling=sp if sampled else None,
            speculative=SpeculativeConfig(cfg, tp, d=3), **kw)
        return e, e.run(_mixed(Request, cfg.vocab_size, specs, seed0=10))

    e1, got1 = run()
    assert e1.n_spec_proposed > 0 and e1.acceptance_rate == 1.0
    _, got2 = run()
    for uid in got1:
        np.testing.assert_array_equal(got1[uid], got2[uid],
                                      err_msg=f"uid {uid}")
    jeng = JaxEngine(jcfg, jp, sampling=_jax_sp(sp),
                     speculative=JaxSpeculativeConfig(jcfg, jp, d=3), **kw)
    want = jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs, seed0=10))
    for uid in want:
        np.testing.assert_array_equal(got1[uid], want[uid],
                                      err_msg=f"uid {uid} vs JAX")
    assert ((e1.n_spec_proposed, e1.n_spec_accepted, e1.n_host_syncs)
            == (jeng.n_spec_proposed, jeng.n_spec_accepted,
                jeng.n_host_syncs))
    _, got_g = run(sampled=False)
    assert any(not np.array_equal(got1[u], got_g[u]) for u in got1)


def test_spec_rejection_sampling_perturbed_draft(qwen):
    """A nearby but different draft: rejection sampling accepts part of
    the proposals, every emitted token lies in the target's filtered
    support after its own prefix, and tokens and acceptance equal JAX's."""
    jcfg, cfg, jp, tp = qwen
    rng = np.random.default_rng(3)
    jd = jax.tree.map(lambda a: (a + 2e-2 * rng.standard_normal(a.shape))
                      .astype(a.dtype), jp)
    sp = SamplingParams(temperature=0.9, top_k=4, seed=13)
    specs = [(4, 10), (8, 8)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2)
    e = ContinuousBatchingEngine(
        cfg, tp, sampling=sp,
        speculative=SpeculativeConfig(cfg, from_jax(jd), d=3), **kw)
    reqs = _mixed(Request, cfg.vocab_size, specs, seed0=90)
    got = e.run(reqs)
    assert 0.0 < e.acceptance_rate < 1.0
    jeng = JaxEngine(jcfg, jp, sampling=_jax_sp(sp),
                     speculative=JaxSpeculativeConfig(jcfg, jd, d=3), **kw)
    want = jeng.run(_mixed(JaxRequest, cfg.vocab_size, specs, seed0=90))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid} vs JAX")
    assert (e.n_spec_proposed, e.n_spec_accepted) == (jeng.n_spec_proposed,
                                                      jeng.n_spec_accepted)
    fam = get_family(cfg)
    for r in reqs:
        cache = fam.init_cache(cfg, 1, MAX_LEN)
        logits, cache = fam.prefill(
            tp, {"tokens": torch.from_numpy(r.prompt)[None]}, cfg, cache)
        pos = len(r.prompt)
        for t in got[r.uid]:
            assert float(sampling.filtered_probs(logits, sp)[0, int(t)]) > 0
            logits, cache = fam.decode_step(
                tp, torch.tensor([int(t)], dtype=torch.int32), pos, cache,
                cfg)
            pos += 1


# ------------------------------------------------------------------ griffin
def test_sampled_griffin_engine_matches_jax():
    """griffin-micro (recurrent state beside ring-window caches that wrap)
    sampled on the dense pool: tokens equal JAX's engine's and the
    sequential replay's, near ties aside."""
    jcfg = jax_get_config("griffin-micro")
    jp, tp = both_params(jcfg)
    cfg = port_config(jcfg)
    sp = SamplingParams(temperature=1.0, top_k=20, top_p=0.95, seed=3)
    specs = [(3, 14), (21, 6), (30, 9), (5, 12)]
    kw = dict(capacity=3, max_len=64, prefill_bucket=4, k=4)
    want = JaxEngine(jcfg, jp, sampling=_jax_sp(sp), **kw).run(
        _mixed(JaxRequest, cfg.vocab_size, specs))
    eng = ContinuousBatchingEngine(cfg, tp, sampling=sp, **kw)
    reqs = _mixed(Request, cfg.vocab_size, specs)
    got = eng.run(reqs)
    assert eng.cache_layout == "recurrent+ring"
    _check_against_replay_and_jax(cfg, tp, reqs, got, want, sp, max_len=64)
    assert len({tuple(v.tolist()) for v in got.values()}) == len(specs)


# ----------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv,notice", [
    (["--temperature", "0.8"], False),
    (["--top-k", "5"], True),
    (["--top-p", "0.9", "--sample-seed", "4", "--pool", "paged",
      "--pages", "20"], True)])
def test_serve_launcher_samples_on_cpu(argv, notice, capsys):
    launch_serve.main(["--arch", "gpt-micro", "--engine", "continuous",
                       "--batch", "3", "--prompt-len", "8", "--gen", "3",
                       "--capacity", "2", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out
    assert ("[serve] --top-k/--top-p without --temperature: sampling at "
            "temperature 1.0" in out) == notice
    assert not set(launch_serve.UNPORTED_FLAGS) & {
        "--temperature", "--top-k", "--top-p", "--sample-seed"}


@pytest.mark.parametrize("flags", [["--temperature", "0.7"],
                                   ["--top-p", "0.5"], ["--policy", "spf"],
                                   ["--pool", "paged"]])
def test_naive_engine_refusals_match_the_reference_text(monkeypatch, flags):
    """The naive loop is greedy lock-step without a slot pool: sampling,
    a policy or a paged pool exit with the reference launcher's text."""
    from repro.launch import serve as jax_serve

    argv = ["--arch", "gpt-micro", *flags]
    with pytest.raises(SystemExit) as port:
        launch_serve.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    with pytest.raises(SystemExit) as reference:
        jax_serve.main()
    assert str(port.value) == str(reference.value)
    assert "require --engine continuous (the naive loop" in str(port.value)
