"""The port's mixture of experts (``repro_torch/models/moe.py`` and the
transformer's two block groups) against the JAX package (CPU).

Module level: the router under both scorings and on exact ties,
``dispatch_combine`` under capacity pressure (k-major priority, drops),
``moe_mlp`` over dispatch groups of 512 and smaller, shared experts and a
bf16 dispatch dtype, and its gradients.  Model level: configs and the
full-width parameter count, the forward's logits and ``moe_aux`` on
phi3.5-moe-42b-smoke and on a two-group config (layers 0-1 dense, 2-3 MoE
with a shared expert), the loss's aux term, a train step.  Serving at the
published capacity factor 1.25, where prefills drop choices: the dense
engine greedy and sampled, the paged pool with prefix hits, speculation on
both pools, a journal resume and a snapshot restore; growth by every
method and the operator steps; both launchers; the bf16 check.

Capacity makes a token's route depend on the shape of the batch it is
computed in, so every engine route is held against JAX's SAME route (same
buckets, same decode and verify groups), never against another route.
Params are made by JAX and converted with ``from_jax``; other inputs come
from seeded numpy.  f32 logits agree within ``F32_ATOL`` (2e-5) unless a
test says otherwise; tokens and counters are equal.
"""
import dataclasses
import importlib.util
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, bf16_logit_errors, jax_params, port_config
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.data.synthetic import lm_batch, lm_data_iter
from repro.launch import serve as jax_launch_serve
from repro.launch import train as jax_launch_train
from repro.models import get_family as jax_family
from repro.models import moe as jmoe
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import EngineKilled, Fault, FaultPlan
from repro.serve import Request as JaxRequest
from repro.serve import RequestJournal as JaxJournal
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import restore_engine as jax_restore_engine
from repro.serve import snapshot_engine as jax_snapshot_engine
from repro.train.loss import lm_loss as jax_lm_loss
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_family, moe, paged_groups
from repro_torch.models import serve_supported, transformer
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
    SpeculativeConfig,
    read_journal,
    recovery_requests,
    restore_engine,
    snapshot_engine,
)
from repro_torch.train.loss import lm_loss
from repro_torch.train.steps import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths


def _chip_smoke_counting_drops():
    """``chip_smoke.counting_drops``: the repo root's script, loaded by
    path (the root is not on the import path of every test run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.counting_drops


counting_drops = _chip_smoke_counting_drops()

SMOKE = "phi3.5-moe-42b-smoke"
MAX_LEN = 48
# jax.eval_shape of the reference's init: all 32 layers, cut to 4, to 2
N_PARAMS = {32: 41_872_527_360, 4: 5_463_904_256, 2: 2_863_288_320}


def _two_group():
    """The reference's MoE serving config (tests/test_serve_consistency.py
    ``test_moe``): layers 0-1 dense, 2-3 MoE with a shared expert, at the
    published capacity factor instead of its 4.0."""
    return JaxConfig(name="moe-two-group", n_layers=4, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=97,
                     moe=True, n_experts=4, top_k=2, expert_d_ff=64,
                     moe_layer_start=2, n_shared_experts=1,
                     capacity_factor=1.25, attn_chunk=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, atol=F32_ATOL, rtol=0.0):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(_np(want)))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=rtol,
                                   err_msg=path)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def phi():
    jcfg = jax_get_config(SMOKE)
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


@pytest.fixture(scope="module")
def two():
    jcfg = _two_group()
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


@pytest.fixture
def model(request, phi, two):
    return {"phi": phi, "two": two}[request.param]


# ------------------------------------------------------------ the module
@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_router_matches_jax(score):
    """Equal indices, weights within 1e-6, aux within 1e-6 relative, over
    16 experts at top 4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    jw, jidx, jaux = jmoe.router(jnp.asarray(x), jnp.asarray(w), top_k=4,
                                 score=score)
    tw, tidx, taux = moe.router(_t(x), _t(w), top_k=4, score=score)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_router_ties_break_like_jax_top_k():
    """Equal scores give JAX's indices: the lower index wins (a zero input
    scores every expert alike; a repeated router column ties two)."""
    x = np.zeros((1, 2, 8), np.float32)
    x[0, 1] = np.linspace(-1, 1, 8)
    w = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    w[:, 9] = w[:, 3]
    w[:, 12] = w[:, 3]
    for score in ("softmax", "sigmoid"):
        _, jidx, _ = jmoe.router(jnp.asarray(x), jnp.asarray(w), top_k=4,
                                 score=score)
        _, tidx, _ = moe.router(_t(x), _t(w), top_k=4, score=score)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        assert list(tidx[0, 0].numpy()) == [0, 1, 2, 3]
    probs = torch.full((16,), 0.0625)
    assert list(moe._topk(probs, 4)[1].numpy()) == [0, 1, 2, 3]


def test_dispatch_combine_under_capacity_pressure_matches_jax():
    """Skewed routing over a capacity of 3: the dispatch and combine
    tensors equal JAX's bit for bit; every token's first choice is placed
    before any second choice (k-major), and the drops are the late ones."""
    rng = np.random.default_rng(2)
    B, S, K, E, C = 2, 10, 2, 4, 3
    idx = np.stack([rng.choice(E, K, replace=False, p=[.55, .25, .1, .1])
                    for _ in range(B * S)]).reshape(B, S, K).astype(np.int32)
    w = rng.random((B, S, K)).astype(np.float32)
    jd, jc = jmoe.dispatch_combine(jnp.asarray(w), jnp.asarray(idx), E, C)
    td, tc = moe.dispatch_combine(_t(w), _t(idx).long(), E, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    kept = td.sum((2, 3)).numpy()
    assert kept.sum() < B * S * K  # choices were dropped
    pos = moe.expert_positions(_t(idx).long(), E).numpy()
    for b in range(B):
        for e in range(E):
            first = [s for s in range(S) if idx[b, s, 0] == e]
            second = [s for s in range(S) if idx[b, s, 1] == e]
            assert [pos[b, s, 0] for s in first] == list(range(len(first)))
            assert [pos[b, s, 1] for s in second] == list(
                range(len(first), len(first) + len(second)))


def _mlp_cfg(**kw):
    base = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                d_ff=32, vocab_size=11, moe=True, n_experts=4, top_k=2,
                expert_d_ff=24, capacity_factor=1.25)
    base.update(kw)
    return JaxConfig(**base)


def _jax_moe_params(jcfg, seed=0):
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 10))
    return _np(jmoe.init_moe(keys, jcfg, layers=None))


@pytest.mark.parametrize("S,group,kw", [
    (8, 512, {}),  # one group of 8
    (1, 512, {}),  # a decode step: one token a group, nothing drops
    (1024, 512, {}),  # two groups of 512 (capacity 320: nothing drops)
    (12, 4, {}),  # groups of 4
    (16, 512, dict(n_shared_experts=2)),
    (16, 512, dict(moe_dispatch_dtype="bfloat16")),
    (16, 512, dict(router_score="sigmoid", n_experts=8, top_k=3)),
])
def test_moe_mlp_matches_jax(S, group, kw, monkeypatch):
    """``moe_mlp`` within 1e-5 of JAX's, aux within 1e-6 relative, at the
    published capacity factor; the groups of at most 16 tokens drop
    choices."""
    jcfg = _mlp_cfg(**kw)
    p = _jax_moe_params(jcfg)
    x = np.random.default_rng(3).standard_normal((2, S, 16)).astype(
        np.float32)
    monkeypatch.setattr(jmoe, "MOE_GROUP_SIZE", group)
    monkeypatch.setattr(moe, "MOE_GROUP_SIZE", group)
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x), p, jcfg)
    cfg = port_config(jcfg)
    with counting_drops(cfg) as drops:
        ty, taux = moe.moe_mlp(_t(x), from_jax(p), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert drops["choices"] == 2 * S * jcfg.top_k
    assert (drops["dropped"] > 0) == (1 < S <= 16), drops


def test_moe_mlp_refuses_a_ragged_group_as_jax_does():
    jcfg = _mlp_cfg()
    p = _jax_moe_params(jcfg)
    x = np.zeros((1, 600, 16), np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_mlp(jnp.asarray(x), p, jcfg)
    with pytest.raises(AssertionError):
        moe.moe_mlp(_t(x), from_jax(p), port_config(jcfg))


def test_moe_mlp_gradients_match_jax():
    """Gradients of a loss through ``moe_mlp`` (output and aux) reach x,
    the experts and the router as JAX's do: through the top-k weights and
    the aux's mean probabilities, not through the one-hots (1e-5)."""
    jcfg = _mlp_cfg(n_shared_experts=1)
    p = _jax_moe_params(jcfg, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 8, 16)).astype(
        np.float32)
    tgt = np.random.default_rng(6).standard_normal((2, 8, 16)).astype(
        np.float32)

    def jloss(p_, x_):
        y, aux = jmoe.moe_mlp(x_, p_, jcfg)
        return jnp.sum(y * tgt) + 3.0 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in from_jax(p).items()}
    tx = _t(x).requires_grad_()
    y, aux = moe.moe_mlp(tx, tp, port_config(jcfg))
    (torch.sum(y * _t(tgt)) + 3.0 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   atol=1e-5, err_msg=k)
    assert float(tp["w_router"].grad.abs().max()) > 0


# -------------------------------------------------------------- the model
@pytest.mark.parametrize("name", ["phi3.5-moe-42b", SMOKE])
def test_phi_configs_equal_the_reference(name):
    assert get_config(name) == port_config(jax_get_config(name))


@pytest.mark.parametrize("layers", [32, 4, 2])
def test_param_shapes_equal_eval_shape(layers):
    """``param_shapes`` of phi3.5-moe-42b (meta device, nothing drawn) is
    JAX's ``eval_shape`` leaf for leaf, whole and cut in depth."""
    jcfg = jax_get_config("phi3.5-moe-42b").replace(n_layers=layers)
    want = {p: tuple(s.shape) for p, s in tree_flatten_with_paths(
        jax.eval_shape(lambda: jax_family(jcfg).init(
            jax.random.PRNGKey(0), jcfg)))}
    got = {p: tuple(s) for p, s in tree_flatten_with_paths(
        transformer.param_shapes(port_config(jcfg)))}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == N_PARAMS[layers]
    assert "dense_blocks" not in {p.split(".")[0] for p in got}


@pytest.mark.parametrize("model", ["phi", "two"], indirect=True)
def test_groups_cache_and_probes_equal_jax(model):
    jcfg, cfg, _, _ = model
    want = _np(jax_family(jcfg).init_cache(jcfg, 3, MAX_LEN))
    got = transformer.init_cache(cfg, 3, MAX_LEN)
    _assert_tree_close(got, want, atol=0)
    assert paged_groups(cfg) == jax_family(jcfg).paged_groups(jcfg)
    assert serve_supported(cfg) == jax_family(jcfg).serve_supported(jcfg)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    assert set(params) == set(jax_family(jcfg).init(jax.random.PRNGKey(0),
                                                    jcfg))


@pytest.mark.parametrize("model", ["phi", "two"], indirect=True)
def test_forward_logits_and_aux_match_jax(model):
    jcfg, cfg, jp, tp = model
    toks = lm_batch(jcfg.vocab_size, 3, 40, seed=3)
    jl, jaux = jax_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)},
                                        jcfg)
    with torch.no_grad(), counting_drops(cfg) as drops:
        tl, taux = transformer.forward(tp, {"tokens": _t(toks)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL)
    np.testing.assert_allclose(float(taux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-6)
    assert drops["dropped"] > 0


@pytest.mark.parametrize("model", ["phi", "two"], indirect=True)
def test_lm_loss_adds_the_weighted_aux_term(model):
    jcfg, cfg, jp, tp = model
    toks = lm_batch(jcfg.vocab_size, 2, 24, seed=4)
    jl, jaux = jax_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)},
                                        jcfg)
    jloss, jm = jax_lm_loss(jl, jaux, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tl, taux = transformer.forward(tp, {"tokens": _t(toks)}, cfg)
        loss, m = lm_loss(tl, taux, {"tokens": _t(toks)}, cfg)
    assert set(m) == set(jm) == {"ce", "moe_aux", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["moe_aux"]),
                               float(taux["moe_aux"]) * cfg.aux_loss_weight,
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(m["ce"] + m["moe_aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("model", ["phi", "two"], indirect=True)
def test_train_step_matches_jax(model):
    """One AdamW train step at B 2 x S 16: loss, ce, moe_aux and grad_norm
    within 2e-5 relative, the gradients within F32_ATOL, and the updated
    params within 1e-5, a hundredth of the learning rate (the first step
    moves a param by about lr * g / (|g| + eps), so a gradient near eps
    turns a rounding difference into a step difference)."""
    jcfg, cfg, jp, _ = model
    toks = lm_batch(jcfg.vocab_size, 2, 16, seed=12)
    seen = {}

    def keep(side):
        def fn(grads):
            seen[side] = grads
            return grads
        return fn

    jopt = JaxOptimizerConfig(lr=1e-3)
    jinit, _ = jax_make_optimizer(jopt)
    jstep = jax_make_train_step(jcfg, jopt, grad_transform=keep("jax"))
    jnew, _, jm = jstep(jp, jinit(jp), {"tokens": jnp.asarray(toks)},
                        jnp.int32(1))
    opt = OptimizerConfig(lr=1e-3)
    init, _ = make_optimizer(opt)
    params = from_jax(jp)
    step = make_train_step(cfg, opt, grad_transform=keep("port"))
    new, _, tm = step(params, init(params), {"tokens": _t(toks)}, 1)
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    _assert_tree_close(seen["port"], seen["jax"])
    _assert_tree_close(new, jnew, atol=1e-5)


def test_prefill_and_decode_steps_match_jax(phi):
    """Scalar prefill over (3, 20) prompts, then 4 decode steps (groups of
    one token): logits within F32_ATOL at every step."""
    jcfg, cfg, jp, tp = phi
    fam = jax_family(jcfg)
    toks = lm_batch(jcfg.vocab_size, 3, 20, seed=5)
    jcache = fam.init_cache(jcfg, 3, MAX_LEN)
    jl, jcache = fam.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jcache)
    with torch.no_grad():
        tcache = transformer.init_cache(cfg, 3, MAX_LEN)
        tl, tcache = transformer.prefill(tp, {"tokens": _t(toks)}, cfg,
                                         tcache)
        for i in range(4):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=F32_ATOL, err_msg=f"step {i}")
            nxt = np.asarray(jl).argmax(-1).astype(np.int32)
            jl, jcache = fam.decode_step(jp, jnp.asarray(nxt), 20 + i,
                                         jcache, jcfg)
            tl, tcache = transformer.decode_step(tp, _t(nxt), 20 + i,
                                                 tcache, cfg)


# ------------------------------------------------------------- the engine
def _reqs(make, vocab, specs, seed0=50):
    return [make(uid=i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _prefix_reqs(make, vocab):
    """Six requests opening on one 16-token prefix (two pages of 8)."""
    prefix = lm_batch(vocab, 1, 16, seed=701)[0]
    return [make(uid=uid, prompt=np.concatenate(
        [prefix, lm_batch(vocab, 1, 2 + uid % 3, seed=900 + uid)[0]]),
        max_new_tokens=5 + uid % 3) for uid in range(6)]


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid]),
                                      np.asarray(want[uid]),
                                      err_msg=f"uid {uid}")


COUNTERS = ("n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_prefix_hits", "n_prefix_misses", "n_spec_proposed",
            "n_spec_accepted")
SPECS = [(3, 6), (9, 8), (5, 8), (12, 4), (20, 7), (30, 5)]
KW = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=8, k=4)


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


def _both(jcfg, cfg, jp, tp, make_reqs, jkw, pkw):
    """(JAX engine, its tokens, port engine, its tokens, port drops)."""
    jeng = JaxEngine(jcfg, jp, **jkw)
    want = jeng.run(make_reqs(JaxRequest))
    eng = ContinuousBatchingEngine(cfg, tp, **pkw)
    with counting_drops(cfg) as drops:
        got = eng.run(make_reqs(Request))
    return jeng, want, eng, got, drops


@pytest.mark.parametrize("model", ["phi", "two"], indirect=True)
def test_dense_engine_matches_jax_with_drops(model):
    """Greedy on the dense pool at capacity factor 1.25: tokens and
    counters equal JAX's; the bucket prefills dropped choices."""
    jcfg, cfg, jp, tp = model
    jeng, want, eng, got, drops = _both(
        jcfg, cfg, jp, tp,
        lambda mk: _reqs(mk, cfg.vocab_size, SPECS), KW, KW)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert drops["dropped"] > 0
    assert eng.cache_layout == "full" and eng.pool_kind == "dense"
    assert set(eng.pool) == ({"moe"} if cfg.moe_layer_start == 0
                             else {"dense", "moe"})


def test_sampled_engine_matches_jax(phi):
    jcfg, cfg, jp, tp = phi
    sp = SamplingParams(temperature=0.8, top_k=12, top_p=0.9, seed=5)
    jsp = JaxSamplingParams(**dataclasses.asdict(sp))
    jeng, want, eng, got, drops = _both(
        jcfg, cfg, jp, tp,
        lambda mk: _reqs(mk, cfg.vocab_size, SPECS[:4], seed0=70),
        dict(KW, sampling=jsp), dict(KW, sampling=sp))
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert drops["dropped"] > 0


@pytest.mark.parametrize("model", ["phi", "two"], indirect=True)
def test_paged_engine_with_prefix_hits_matches_jax(model):
    """A paged pool of 10 pages over six requests sharing a 16-token
    prefix: hits prefill their tails through decode steps, as JAX's do;
    tokens and counters equal JAX's; no page stays in use."""
    jcfg, cfg, jp, tp = model
    kw = dict(KW, pool="paged", pages=10)
    jeng, want, eng, got, drops = _both(
        jcfg, cfg, jp, tp, lambda mk: _prefix_reqs(mk, cfg.vocab_size),
        kw, kw)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
    assert drops["dropped"] > 0
    assert all("bt" in g for g in eng.pool.values())


def _nudged(jp, scale=1e-2, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * rng.standard_normal(
        a.shape)).astype(a.dtype), jp)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_speculation_matches_jax(phi, pool):
    """A nudged copy drafts at d 3, K 2: each verify routes its 4 tokens
    as one group (capacity 2 an expert).  Tokens and counters equal JAX's
    speculative engine; acceptance strictly inside (0, 1)."""
    jcfg, cfg, jp, tp = phi
    jd = _nudged(jp, scale=3e-3)
    kw = dict(KW, k=2)
    if pool == "paged":
        kw.update(pool="paged", pages=16)
    jeng, want, eng, got, _ = _both(
        jcfg, cfg, jp, tp,
        lambda mk: _reqs(mk, cfg.vocab_size, SPECS[:4], seed0=60),
        dict(kw, speculative=JaxSpeculativeConfig(jcfg, jd, d=3)),
        dict(kw, speculative=SpeculativeConfig(cfg, from_jax(jd), d=3)))
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert 0.0 < eng.acceptance_rate < 1.0
    assert eng.pool_kind == pool and eng.n_spec_fallbacks == 0
    if pool == "paged":
        assert eng.pages_in_use == 0 and "bt" in eng.pool_d["moe"]


def test_journal_resume_of_a_jax_crash_matches_jax(phi, tmp_path):
    """JAX's paged engine dies at dispatch 2 with a journal; the port
    resumes it on its "moe" group, JAX resumes a copy: equal admissions
    step by step, tokens equal JAX's uninterrupted run."""
    jcfg, cfg, jp, tp = phi
    kw = dict(KW, pool="paged", pages=10)
    want = JaxEngine(jcfg, jp, **kw).run(_prefix_reqs(JaxRequest,
                                                      cfg.vocab_size))
    path = tmp_path / "j.jsonl"
    j = JaxJournal(str(path))
    with pytest.raises(EngineKilled):
        JaxEngine(jcfg, jp, journal=j, faults=FaultPlan([Fault("crash", 2)]),
                  **kw).run(_prefix_reqs(JaxRequest, cfg.vocab_size))
    j.close()
    resumed, done = recovery_requests(read_journal(str(path)))
    assert any(r.n_committed > 0 for r in resumed)
    shutil.copy(path, tmp_path / "copy.jsonl")
    from repro.serve import read_journal as jax_read_journal
    from repro.serve import recovery_requests as jax_recovery_requests
    jresumed, _ = jax_recovery_requests(jax_read_journal(
        str(tmp_path / "copy.jsonl")))
    eng = ContinuousBatchingEngine(cfg, tp, **kw)
    jeng = JaxEngine(jcfg, jp, **kw)
    for r, jr in zip(resumed, jresumed):
        eng.submit(r)
        jeng.submit(jr)
    while eng.waiting or eng.active:
        eng.step()
        jeng.step()
        assert set(eng.active) == set(jeng.active)
    eng.run()
    _assert_same({**done, **eng.finished}, want)
    assert eng.pages_in_use == 0


def test_snapshot_restores_across_packages(phi, tmp_path):
    """A paged port engine's snapshot restores in JAX and JAX's in the
    port; all three serve the same tokens."""
    jcfg, cfg, jp, tp = phi
    kw = dict(KW, pool="paged", pages=12)
    eng = ContinuousBatchingEngine(cfg, tp, **kw)
    snapshot_engine(eng, str(tmp_path / "port"), step=1)
    jeng = jax_restore_engine(str(tmp_path / "port"))
    assert (jeng.capacity, jeng.pool_kind, jeng.pages_arg) == (3, "paged",
                                                                12)
    a = eng.run(_reqs(Request, cfg.vocab_size, SPECS[:4], seed0=80))
    b = jeng.run(_reqs(JaxRequest, cfg.vocab_size, SPECS[:4], seed0=80))
    _assert_same(a, b)
    jax_snapshot_engine(jeng, str(tmp_path / "jax"), step=2)
    eng2 = restore_engine(str(tmp_path / "jax"), device="cpu")
    assert set(eng2.pool) == {"moe"} and eng2.cfg.name == SMOKE
    _assert_same(eng2.run(_reqs(Request, cfg.vocab_size, SPECS[:4],
                                seed0=80)), a)


# ----------------------------------------------------------------- growth
def _grow_pair(method):
    """phi3.5-moe-42b-smoke (2 x 64) into a 4 x 128 MoE of 4 experts;
    StackBERT, which only grows depth, into 4 x 64."""
    js = jax_get_config(SMOKE)
    if method == "stackbert":
        return js, js.replace(name="phi-smoke-deep", n_layers=4)
    return js, js.replace(name="phi-smoke-big", n_layers=4, d_model=128,
                          n_heads=8, n_kv_heads=2, d_ff=256,
                          expert_d_ff=256)


@pytest.mark.parametrize("method", jgrow.METHODS)
def test_grow_params_equals_jax(method):
    """Each method grows converted phi smoke weights into the larger MoE
    as JAX does (the router and the 4-D expert slots included), with
    JAX's operator params and trainable count."""
    js, jt = _grow_pair(method)
    src = jax_params(js, seed=1)
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    want = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build(method, port_config(js), port_config(jt), rank=1,
                        device="cpu")
    op_params = from_jax(_np(jop))
    got = grow.grow_params(gop, op_params, from_jax(src))
    _assert_tree_close(got, want, atol=1e-6)
    assert grow.operator_param_count(gop, op_params) == \
        jgrow.operator_param_count(jgop, jop)
    assert gop.trainable == jgop.trainable


def test_train_operator_follows_jax():
    """Three bare-AdamW Mango operator steps (Eq. 7) into the MoE, the aux
    term in the loss: losses within 2e-5 relative, the trained operator
    within 1e-4."""
    from repro.train.loss import loss_for as jax_loss_for
    from repro_torch.train.loss import loss_for

    js, jt = _grow_pair("mango")
    ts, tt = port_config(js), port_config(jt)
    src = jax_params(js, seed=4)
    jgop, jop = jgrow.build("mango", js, jt, rank=1)
    jfam, jloss = jax_family(jt), jax_loss_for(jt)
    it = lm_data_iter(jt.vocab_size, 2, 24, seed=9)
    batches = [next(it) for _ in range(3)]

    def jax_op_loss(big, b):
        logits, aux = jfam.forward(big, b, jt)
        return jloss(logits, aux, b, jt)[0]

    op0 = from_jax(_np(jop))
    jop, jlosses = jgrow.train_operator(
        jgop, jop, src, jax_op_loss,
        iter({"tokens": jnp.asarray(b["tokens"])} for b in batches), steps=3)
    gop, _ = grow.build("mango", ts, tt, rank=1, device="cpu")
    loss = loss_for(tt)

    def op_loss(big, b):
        logits, aux = transformer.forward(big, b, tt)
        return loss(logits, aux, b, tt)[0]

    op_params, losses = grow.train_operator(gop, op0, from_jax(src), op_loss,
                                            iter(batches), steps=3)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    _assert_tree_close(op_params, jop, atol=1e-4)


# -------------------------------------------------------------- launchers
def _jax_init_as_port(monkeypatch):
    """Both launchers draw phi smoke's weights the same way: the port's
    ``transformer.init`` returns JAX's init at the launchers' seed 0,
    converted."""
    def init(gen, cfg, device=None):
        jcfg = jax_get_config(cfg.name)
        return from_jax(_np(jax_family(jcfg).init(jax.random.PRNGKey(0),
                                                  jcfg)))
    monkeypatch.setattr(transformer, "init", init)


def _token_lines(out):
    return [line for line in out.splitlines() if re.match(r"^\d+ \[", line)]


@pytest.mark.parametrize("extra,pool", [
    ([], "dense"), (["--pool", "paged", "--pages", "8"], "paged"),
    (["--speculate", "--draft", SMOKE, "--spec-d", "3"], "dense")])
def test_serve_launcher_matches_jax(capsys, monkeypatch, extra, pool):
    _jax_init_as_port(monkeypatch)
    argv = ["--arch", SMOKE, "--engine", "continuous", "--batch", "4",
            "--prompt-len", "12", "--gen", "6", "--capacity", "2", *extra]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jax_launch_serve.main()
    jout = capsys.readouterr().out
    launch_serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"transformer/full ({pool} pool) on cpu served 4 requests" in out
    assert _token_lines(out) == _token_lines(jout) != []


def test_train_launcher_matches_jax(monkeypatch):
    """Three steps of the train launcher at phi smoke from JAX's weights:
    losses and grad norms within 1e-4 relative."""
    _jax_init_as_port(monkeypatch)
    kw = dict(steps=3, batch=2, seq=32, log_every=1)
    _, jhist = jax_launch_train.train(SMOKE, log_fn=lambda *_: None, **kw)
    _, hist = launch_train.train(SMOKE, device="cpu",
                                 log_fn=lambda *_: None, **kw)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for h, jh in zip(hist, jhist):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(h[k], jh[k], rtol=1e-4,
                                       err_msg=f"step {h['step']} {k}")


def test_unported_moe_variants_still_refused():
    """MoE is ported, and MLA, the MTP head and M-RoPE beside it: the
    latent cache groups, the "mtp" params and M-RoPE's K/V groups and
    params have JAX's shapes and the config serves as JAX's does."""
    jcfg = JaxConfig(name="x", moe=True, n_experts=4, top_k=2,
                     expert_d_ff=16, moe_layer_start=1)
    cfg = port_config(jcfg)
    assert serve_supported(cfg)[0]
    mla = dict(mla=True, kv_lora_rank=8, q_lora_rank=8, qk_nope_dim=8,
               qk_rope_dim=8, v_head_dim=8)
    for kw in (mla, dict(mtp=True), dict(mla, mtp=True),
               dict(rope="mrope", mrope_sections=(2, 3, 3))):
        jc, c = jcfg.replace(**kw), cfg.replace(**kw)
        want = _np(jax_family(jc).init_cache(jc, 1, 8))
        _assert_tree_close(transformer.init_cache(c, 1, 8), want, atol=0)
        wshapes = {p: tuple(s.shape) for p, s in tree_flatten_with_paths(
            jax.eval_shape(lambda: jax_family(jc).init(
                jax.random.PRNGKey(0), jc)))}
        gshapes = {p: tuple(s) for p, s in tree_flatten_with_paths(
            transformer.param_shapes(c))}
        assert gshapes == wshapes
        assert serve_supported(c) == jax_family(jc).serve_supported(jc)
        assert serve_supported(c)[0]


# ------------------------------------------------------------------- bf16
def test_bf16_logit_error_at_most_jax():
    """ROADMAP 1.3 on phi smoke: the port's bf16 route (prefill, then 8
    decode steps fed the same tokens) is no further from the f32 route
    than JAX's bf16 route is."""
    jcfg = jax_get_config(SMOKE)
    prompts = lm_batch(jcfg.vocab_size, 2, 24, seed=17)
    port_err, jax_err, scale = bf16_logit_errors(jcfg, jax_params(jcfg),
                                                 prompts, n_steps=8)
    assert 0.0 < port_err <= jax_err, (port_err, jax_err, scale)


def test_generate_matches_jax(phi):
    """``generate`` (scalar prefill, decode groups of one token) equals
    JAX's ``generate`` on three prompts."""
    from repro.launch.serve import generate as jax_generate

    jcfg, cfg, jp, tp = phi
    prompts = lm_batch(jcfg.vocab_size, 3, 14, seed=21)
    want = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts),
                                   max_new_tokens=8))
    got = launch_serve.generate(cfg, tp, _t(prompts), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert get_family(cfg) is transformer
