"""qwen2-vl (multimodal RoPE) in the port against the JAX package (CPU),
and every reference architecture's config.

M-RoPE turns the head's half-dim frequencies in three sections, each by
its own position stream (t, h, w).  With three equal streams it is 1-D
RoPE exactly, and every serving route builds equal streams, so the
module, forward, loss, train step and growth checks feed three DISTINCT
rows: text, then an image span whose t stream stands still while h and w
walk its grid, then text again from the span's largest position + 1, as
Qwen2-VL numbers them.  A check shows that these rows make ``apply_mrope``
differ from ``apply_rope``.

qwen2-vl-72b-smoke then serves through the engine against JAX's: dense,
paged under page pressure with prefix hits, sampled, and speculative with
a nudged draft whose acceptance lies strictly inside (0, 1); its model
routes (prefill and scalar decode, slot decode, verify and commit, the
paged pool) run in ``test_torch_rope.py`` beside the RoPE decoders'.
Params are JAX's init redrawn from seeded numpy and converted; f32 logits
agree within ``F32_ATOL``, tokens and engine counters exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, port_config, redrawn_params
from repro.configs import archs as jarchs
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.data.synthetic import lm_batch
from repro.models import get_family as jax_family
from repro.models import rope as jrope
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.train.loss import lm_loss as jax_lm_loss
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import archs, get_config
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.models import rope, serve_supported, transformer
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
    SpeculativeConfig,
)
from repro_torch.train.loss import lm_loss
from repro_torch.train.steps import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths

SMOKE = "qwen2-vl-72b-smoke"
MAX_LEN = 64  # pad_cache_len(64) = 64: page 8, 8 blocks a slot


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=F32_ATOL, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=err_msg)


def _tree_close(got, want, atol=F32_ATOL):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, want)))
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(g[path], w[path], atol=atol, err_msg=path)


def mrope_positions(B, S, grid=(4, 4)):
    """(3, B, S) Qwen2-VL positions: row b opens with 3 + 2b text tokens
    (t = h = w = i), then an image of ``grid`` (gh, gw) patches at t =
    start, h = start + row, w = start + col, then text again from start +
    max(gh, gw) on (the span's largest position + 1)."""
    gh, gw = grid
    pos = np.zeros((3, B, S), np.int32)
    for b in range(B):
        start = 3 + 2 * b
        pos[:, b, :start] = np.arange(start)
        n = gh * gw
        rows, cols = np.divmod(np.arange(n), gw)
        pos[0, b, start:start + n] = start
        pos[1, b, start:start + n] = start + rows
        pos[2, b, start:start + n] = start + cols
        tail = S - start - n
        assert tail > 0, (S, start, n)
        pos[:, b, start + n:] = start + max(gh, gw) + np.arange(tail)
    return pos


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = jax_get_config(SMOKE)
        _MODEL["m"] = (jcfg, port_config(jcfg), *redrawn_params(jcfg))
    return _MODEL["m"]


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", [n + s for n in jarchs.ARCH_IDS
                                  for s in ("", "-smoke")])
def test_every_reference_arch_has_its_port_config(name):
    """The port registers all ten reference architectures and their
    ``-smoke`` twins, each equal to the JAX config minus its TPU-only
    knobs, in the reference's ``ARCH_IDS`` order."""
    assert archs.ARCH_IDS == jarchs.ARCH_IDS
    assert get_config(name) == port_config(jax_get_config(name))


@pytest.mark.parametrize("name,layers,n_params", [
    ("qwen2-vl-72b", 2, 4_246_794_240), ("hubert-xlarge", 48, 988_193_280)])
def test_full_width_param_counts_equal_jax(name, layers, n_params):
    """Param shapes at full width (the port's meta device, JAX's
    eval_shape) equal leaf for leaf: qwen2-vl-72b cut to 2 of 80 layers
    (the chip phase's depth) and hubert-xlarge whole."""
    jcfg = jax_get_config(name).replace(n_layers=layers)
    want = dict(tree_flatten_with_paths(jax.tree.map(
        lambda s: tuple(s.shape), jax.eval_shape(
            lambda: jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg)))))
    got = {p: tuple(s) for p, s in tree_flatten_with_paths(
        transformer.param_shapes(port_config(jcfg)))}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == n_params


# ----------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd):
    """Three distinct rows: the port's rotation equals JAX's within
    F32_ATOL, and differs from 1-D RoPE at the temporal positions (the
    inputs tell the two apart); three equal rows give ``apply_rope``
    exactly, in both packages; a section sum other than hd / 2 is
    refused, as JAX refuses it."""
    B, S, H = 2, 24, 3
    x = np.random.default_rng(hd).standard_normal((B, S, H, hd)).astype(
        np.float32)
    pos3 = mrope_positions(B, S)
    kw = dict(theta=1e6, sections=sections)
    got = rope.apply_mrope(_t(x), _t(pos3), **kw)
    _close(got, jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), **kw))
    one_d = rope.apply_rope(_t(x), _t(pos3[1]), theta=1e6)
    assert float((got - one_d).abs().max()) > 0.1
    same = np.broadcast_to(pos3[1], (3, B, S))
    assert torch.equal(rope.apply_mrope(_t(x), _t(same.copy()), **kw),
                       one_d)
    np.testing.assert_array_equal(
        np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(same),
                                     **kw)),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos3[1]),
                                    theta=1e6)))
    with pytest.raises(AssertionError):
        rope.mrope_tables(_t(pos3), hd + 2, **kw)


def test_forward_matches_jax_on_distinct_rows():
    """The full forward over (3, B, S) positions, and over none (three
    equal rows of arange, built by ``_positions_from_batch``): logits
    within F32_ATOL of JAX's; the distinct rows change the logits."""
    jcfg, cfg, jp, tp = _model()
    toks = lm_batch(cfg.vocab_size, 2, 24, seed=3)
    pos3 = mrope_positions(2, 24)
    jfwd = jax.jit(lambda p, b: jax_family(jcfg).forward(p, b, jcfg)[0])
    got = transformer.forward(tp, {"tokens": _t(toks), "positions":
                                   _t(pos3)}, cfg)[0]
    _close(got, jfwd(jp, {"tokens": jnp.asarray(toks),
                          "positions": jnp.asarray(pos3)}))
    plain = transformer.forward(tp, {"tokens": _t(toks)}, cfg)[0]
    _close(plain, jfwd(jp, {"tokens": jnp.asarray(toks)}))
    assert float((got - plain).abs().max()) > 1e-3


def test_loss_and_train_step_match_jax_on_distinct_rows():
    """``lm_loss`` and one AdamW train step over a batch carrying (3, B,
    S) positions: loss, ce and grad_norm within 2e-5 relative, the
    gradients within F32_ATOL, the updated params within 1e-5 at lr 1e-4
    (the first step moves a param by about lr * g / (|g| + eps), so a
    gradient near eps turns a rounding difference into a step difference
    of up to lr: at lr 1e-3 one entry of wo, and one of the key bias,
    whose gradient is near zero as attention is nearly blind to a shift
    shared by every key, moved 1.3e-5 and 4.4e-5 apart)."""
    jcfg, cfg, jp, _ = _model()
    toks = lm_batch(cfg.vocab_size, 2, 24, seed=4)
    pos3 = mrope_positions(2, 24)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos3)}
    tb = {"tokens": _t(toks), "positions": _t(pos3)}
    jl, jaux = jax_family(jcfg).forward(jp, jb, jcfg)
    _, jm = jax_lm_loss(jl, jaux, jb, jcfg)
    tl, taux = transformer.forward(from_jax(jp), tb, cfg)
    _, tm = lm_loss(tl, taux, tb, cfg)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   err_msg=k)
    seen = {}

    def keep(side):
        def fn(grads):
            seen[side] = grads
            return grads
        return fn

    jinit, _ = jax_make_optimizer(JaxOptimizerConfig(lr=1e-4))
    jnew, _, jm = jax_make_train_step(
        jcfg, JaxOptimizerConfig(lr=1e-4), grad_transform=keep("jax"))(
        jp, jinit(jp), jb, jnp.int32(1))
    init, _ = make_optimizer(OptimizerConfig(lr=1e-4))
    params = from_jax(jp)
    new, _, tm = make_train_step(cfg, OptimizerConfig(lr=1e-4),
                                 grad_transform=keep("port"))(
        params, init(params), tb, 1)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    _tree_close(seen["port"], seen["jax"])
    _tree_close(new, jnew, atol=1e-5)


def _grow_pair(method):
    """qwen2-vl-72b-smoke (2 x 64) into 4 x 128 (8 heads over 4 KV heads
    of 16, sections (2, 3, 3)); StackBERT, which only grows depth, into
    4 x 64."""
    js = jax_get_config(SMOKE)
    if method == "stackbert":
        return js, js.replace(name="qwen2-vl-smoke-deep", n_layers=4)
    return js, js.replace(name="qwen2-vl-smoke-big", n_layers=4,
                          d_model=128, n_heads=8, n_kv_heads=4, d_ff=320)


@pytest.mark.parametrize("method", jgrow.METHODS)
def test_grow_params_equals_jax(method):
    """Each method grows converted qwen2-vl smoke weights as JAX does
    (leaves within 1e-5, the qkv biases included), with JAX's operator
    params and trainable count; the grown model's forward over distinct
    rows equals JAX's."""
    js, jt = _grow_pair(method)
    src = redrawn_params(js, seed=1)[0]
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    want = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build(method, port_config(js), port_config(jt), rank=1,
                        device="cpu")
    op_params = from_jax(jax.tree.map(np.asarray, jop))
    got = grow.grow_params(gop, op_params, from_jax(src))
    _tree_close(got, want, atol=1e-5)
    assert grow.operator_param_count(gop, op_params) == \
        jgrow.operator_param_count(jgop, jop)
    assert gop.trainable == jgop.trainable
    toks = lm_batch(jt.vocab_size, 2, 24, seed=5)
    pos3 = mrope_positions(2, 24)
    wl = jax_family(jt).forward(want, {"tokens": jnp.asarray(toks),
                                       "positions": jnp.asarray(pos3)}, jt)[0]
    gl = transformer.forward(got, {"tokens": _t(toks),
                                   "positions": _t(pos3)},
                             port_config(jt))[0]
    _close(gl, wl, atol=1e-4)


# ---------------------------------------------------------------- engine
COUNTERS = ("n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_prefix_hits", "n_prefix_misses", "n_spec_proposed",
            "n_spec_accepted")
KW = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=8, k=4)


def _specs(vocab):
    """Eight requests: five open with the same 18 tokens (two full pages
    of 8) and three have their own; budgets of 6..20 tokens."""
    prefix = lm_batch(vocab, 1, 18, seed=300)[0]
    shared = [(np.concatenate([prefix, lm_batch(vocab, 1, 3 + 2 * i,
                                                seed=320 + i)[0]]),
               6 + 3 * i) for i in range(5)]
    own = [(lm_batch(vocab, 1, p, seed=310 + i)[0], g)
           for i, (p, g) in enumerate([(26, 12), (5, 20), (14, 9)])]
    return [shared[4], own[0], own[1], shared[0], shared[1], own[2],
            shared[2], shared[3]]


def _reqs(make, specs):
    return [make(uid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(specs)]


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid]),
                                      np.asarray(want[uid]),
                                      err_msg=f"uid {uid}")


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


def _both(jkw, pkw, specs, jp=None, tp=None):
    """(JAX engine, its tokens, port engine, its tokens)."""
    jcfg, cfg, jp0, tp0 = _model()
    jeng = JaxEngine(jcfg, jp0 if jp is None else jp, **jkw)
    want = jeng.run(_reqs(JaxRequest, specs))
    eng = ContinuousBatchingEngine(cfg, tp0 if tp is None else tp, **pkw)
    return jeng, want, eng, eng.run(_reqs(Request, specs))


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_engine_matches_jax_engine(pool):
    """qwen2-vl-72b-smoke greedy at capacity 3: the dense pool, and a
    paged pool of 12 pages under page pressure whose later waves hit the
    shared prefix.  Tokens and counters equal JAX's engine; tokens equal
    ``generate`` (the flash and decode_attention routes); no page is left
    in use."""
    jcfg, cfg, _, tp = _model()
    kw = dict(KW, pool=pool, pages=12 if pool == "paged" else None)
    specs = _specs(cfg.vocab_size)
    jeng, want, eng, got = _both(kw, kw, specs)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    _assert_same(got, {r.uid: generate(cfg, tp, _t(r.prompt)[None],
                                       max_new_tokens=r.max_new_tokens,
                                       max_len=MAX_LEN)[0].numpy()
                       for r in _reqs(Request, specs)})
    assert len({int(t) for v in got.values() for t in v}) > 20
    if pool == "paged":
        assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
        assert eng.pages_highwater == 12


def test_sampled_engine_matches_jax():
    """Sampled (temperature 0.8, top-k 12, top-p 0.9) on the paged pool
    with prefix hits: tokens and counters equal JAX's engine."""
    sp = SamplingParams(temperature=0.8, top_k=12, top_p=0.9, seed=5)
    jsp = JaxSamplingParams(**dataclasses.asdict(sp))
    kw = dict(KW, pool="paged", pages=12)
    specs = _specs(_model()[1].vocab_size)
    jeng, want, eng, got = _both(dict(kw, sampling=jsp),
                                 dict(kw, sampling=sp), specs)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert eng.n_prefix_hits > 0


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_speculation_matches_jax(pool):
    """A copy nudged by seeded numpy noise drafts at d 3, K 2 (paged: one
    arena of 24 pages for both): tokens, proposals, acceptances and every
    counter equal JAX's speculative engine, acceptance strictly inside
    (0, 1)."""
    jcfg, cfg, jp, _ = _model()
    rng = np.random.default_rng(7)
    jd = jax.tree.map(lambda a: (a + 1e-3 * rng.standard_normal(
        a.shape)).astype(a.dtype), jp)
    kw = dict(KW, k=2, pool=pool, pages=24 if pool == "paged" else None)
    specs = _specs(cfg.vocab_size)
    jeng, want, eng, got = _both(
        dict(kw, speculative=JaxSpeculativeConfig(jcfg, jd, d=3)),
        dict(kw, speculative=SpeculativeConfig(cfg, from_jax(jd), d=3)),
        specs)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert 0.0 < eng.acceptance_rate < 1.0
    assert eng.n_spec_fallbacks == 0
    assert eng.pages_in_use in (None, 0)


def test_serve_launcher_serves_qwen2vl_on_cpu(capsys):
    launch_serve.main(["--arch", SMOKE, "--engine", "continuous", "--batch",
                       "4", "--prompt-len", "24", "--gen", "5", "--pool",
                       "paged", "--pages", "9", "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("[continuous] transformer/full (paged pool) on cpu served 4 "
            "requests / 20 tokens") in out
    assert serve_supported(get_config(SMOKE)) == jax_family(
        jax_get_config(SMOKE)).serve_supported(jax_get_config(SMOKE))
