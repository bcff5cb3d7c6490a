"""The port's multi-head latent attention and MTP head
(``repro_torch/models/transformer.py``'s MLA routes, ``train/loss.py``'s
MTP term, ``kernels/ops.paged_latent_gather``) against the JAX package
(CPU).

Module level: ``_mla_forward`` on every route -- the uncached forward,
the cached prefill (expanded K/V over the cache up to ``q_offset + S``),
the scalar decode (absorbed), the dense and the paged slot decode
(absorbed, with done rows' exact zeros) and the chunk verify over a dense
and a paged latent cache (done rows' zeros, the pending raw latents) --
on deepseek-v3-671b-smoke and on the reference's MLA-only serving config
(``tests/test_serve_consistency.py::test_mla``, no MoE), and the paged
latent gather against its plain twin and JAX's.  Model level: configs,
the full-width parameter count, cache groups and probes, ``forward``'s
logits and ``mtp_logits``, ``lm_loss``'s MTP and MoE terms, a train step,
prefill and decode.  Serving: on the MLA-only config (nothing routes) the
dense engine (== ``generate``), the paged pool with prefix hits,
speculation on both pools and sampling, each == JAX's same route; on
deepseek-smoke at the published capacity factor 1.25, where prefills
drop choices, the same routes == JAX's same routes; the reference's
``test_paged_mla_latent_parity`` trace (paged == dense at 1.25 in both
packages, ``generate`` == both at E / K); a fault plan on the dense pool,
and a ``nan`` fault on a paged latent pool (``KeyError('k')`` in both
packages); a journal resume and a snapshot restore on latent groups.
Growth by every method and the operator steps; both launchers; the bf16
check.

Params are made by JAX and converted with ``from_jax``; other inputs come
from seeded numpy.  f32 outputs agree within ``F32_ATOL`` (2e-5) unless a
test says otherwise; tokens and counters are equal.  Routing capacity
makes a token's route depend on the shape of the batch it is computed in,
so every engine route is held against JAX's SAME route.
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
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.launch import serve as jax_launch_serve
from repro.launch import train as jax_launch_train
from repro.models import get_family as jax_family
from repro.models import transformer as jtr
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import EngineKilled, Fault
from repro.serve import FaultPlan as JaxFaultPlan
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
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import paged_groups, serve_supported, transformer
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    FaultPlan,
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

SMOKE = "deepseek-v3-671b-smoke"
MAX_LEN = 48
# jax.eval_shape of the reference's init: (layers, moe_layer_start) ->
# params; 61 layers is the published model
N_PARAMS = {(61, 3): 671_712_662_528, (2, 1): 14_630_392_832,
            (1, 1): 3_123_106_816}


def _mla_only():
    """The reference's MLA serving config (tests/test_serve_consistency.py
    ``test_mla``): three MLA layers, a dense MLP, no MoE, no MTP head."""
    return JaxConfig(name="a", n_layers=3, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab_size=97, mla=True,
                     q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                     qk_rope_dim=8, v_head_dim=16, attn_chunk=8)


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
def ds():
    jcfg = jax_get_config(SMOKE)
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


@pytest.fixture(scope="module")
def mla():
    jcfg = _mla_only()
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


@pytest.fixture(scope="module")
def ds1():
    """deepseek-smoke cut to its dense layer (with the MTP head): an MoE
    config with no MoE layer, phase 20d's cut at smoke size."""
    jcfg = jax_get_config(SMOKE).replace(n_layers=1)
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


@pytest.fixture
def model(request, ds, mla, ds1):
    return {"ds": ds, "mla": mla, "ds1": ds1}[request.param]


# ------------------------------------------------------------ the module
def _layer0(jp, tp):
    """The first dense block's attention params, JAX's and the port's."""
    return (jax.tree.map(lambda a: jnp.asarray(a[0]),
                         jp["dense_blocks"]["attn"]),
            {k: v[0] for k, v in tp["dense_blocks"]["attn"].items()})


def _latents(jcfg, B, Sc, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sc, jcfg.kv_lora_rank)).astype(
        np.float32), rng.standard_normal((B, Sc, jcfg.qk_rope_dim)).astype(
        np.float32))


def _routes_pair(jcfg, cfg, jp, tp, x, positions, **kw):
    """JAX's ``_mla_forward`` and the port's on the same x and positions
    (the port's rope table built at qk_rope_dim, as its layer stack
    builds it).  Returns (JAX out, JAX second, port out, port second)."""
    jparams, tparams = _layer0(jp, tp)
    jkw = {k: v[0] for k, v in kw.items()}
    pkw = {k: v[1] for k, v in kw.items()}
    jout, jsecond = jtr._mla_forward(jnp.asarray(x), jparams, jcfg,
                                     jnp.asarray(positions), **jkw)
    with torch.no_grad():
        out, second = transformer._mla_forward(
            _t(x), tparams, cfg,
            rope=transformer._rope(cfg, _t(positions), torch.float32), **pkw)
    return jout, jsecond, out, second


ROUTE_MODELS = ["ds", "mla"]


@pytest.mark.parametrize("model", ROUTE_MODELS, indirect=True)
def test_uncached_forward_route_matches_jax(model):
    jcfg, cfg, jp, tp = model
    B, S = 2, 11
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, _, out, _ = _routes_pair(jcfg, cfg, jp, tp, x, pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL)


@pytest.mark.parametrize("model", ROUTE_MODELS, indirect=True)
@pytest.mark.parametrize("q_offset,S", [(0, 9), (5, 6), (7, 1)])
def test_cached_prefill_and_scalar_decode_match_jax(model, q_offset, S):
    """A cached prefill at q_offset 0 and 5 (expanded K/V over the cache
    up to q_offset + S) and the scalar decode (S 1, absorbed) over a cache
    whose first q_offset positions hold earlier latents: output and the
    written latent cache."""
    jcfg, cfg, jp, tp = model
    B, Sc = 2, 16
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(q_offset + np.arange(S, dtype=np.int32), (B, S))
    cc, cr = _latents(jcfg, B, Sc, 3)
    jcache = {"ckv": jnp.asarray(cc), "kr": jnp.asarray(cr)}
    cache = {"ckv": _t(cc), "kr": _t(cr)}
    jout, jnew, out, new = _routes_pair(
        jcfg, cfg, jp, tp, x, pos, cache=(jcache, cache),
        q_offset=(q_offset, q_offset))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL)
    _assert_tree_close(new, jnew, atol=1e-6)
    assert new is cache  # updated in place


def _slot_case(jcfg, B, Sc, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    positions = np.array([5, 0, 12, 9], np.int32)[:B]
    done = np.array([False, False, True, False])[:B]
    return x, positions, done


@pytest.mark.parametrize("model", ROUTE_MODELS, indirect=True)
@pytest.mark.parametrize("with_done", [False, True])
def test_dense_slot_decode_matches_jax(model, with_done):
    """Per-row scatter, then the absorbed attention at per-row kv_len: a
    done row writes too (as JAX's does) and returns exact zeros."""
    jcfg, cfg, jp, tp = model
    B, Sc = 4, 16
    x, positions, done = _slot_case(jcfg, B, Sc, 4)
    cc, cr = _latents(jcfg, B, Sc, 5)
    jd = jnp.asarray(done) if with_done else None
    td = _t(done) if with_done else None
    jout, jnew, out, new = _dense_slot(jcfg, cfg, jp, tp, x, positions, cc,
                                       cr, jd, td)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL)
    _assert_tree_close(new, jnew, atol=1e-6)
    if with_done:
        assert (out[2] == 0).all()


def _dense_slot(jcfg, cfg, jp, tp, x, positions, cc, cr, jd, td):
    jparams, tparams = _layer0(jp, tp)
    jout, jnew = jtr._mla_forward(
        jnp.asarray(x), jparams, jcfg, jnp.asarray(positions)[:, None],
        cache={"ckv": jnp.asarray(cc), "kr": jnp.asarray(cr)},
        slot_positions=jnp.asarray(positions), slot_done=jd)
    pos = _t(positions)
    cache = {"ckv": _t(cc), "kr": _t(cr)}
    with torch.no_grad():
        out, new = transformer._mla_forward(
            _t(x), tparams, cfg,
            rope=transformer._rope(cfg, pos[:, None], torch.float32),
            cache=cache, slot_positions=pos.long(),
            slot_kv_len=transformer._slot_kv_len(pos, td).to(torch.int32),
            slot_done=td)
    return jout, jnew, out, new


def _paged_arenas(jcfg, n_pages, page, seed):
    """JAX's arenas (n_pages, page, r) and the port's, which carry one
    scratch page more (``serve/paged.py``)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_pages, page, jcfg.kv_lora_rank)).astype(
        np.float32)
    b = rng.standard_normal((n_pages, page, jcfg.qk_rope_dim)).astype(
        np.float32)

    def plus(z):
        return np.concatenate([z, np.zeros_like(z[:1])])

    return (a, b), (plus(a), plus(b))


# four rows over 3 blocks of 8: a sentinel block (index n_pages = 9) past
# each row's pages, rows sharing page 4 as a prefix would
BT = np.array([[4, 1, 9], [4, 7, 2], [0, 9, 9], [3, 5, 8]], np.int32)


@pytest.mark.parametrize("model", ROUTE_MODELS, indirect=True)
def test_paged_slot_decode_matches_jax(model):
    """The write through the block table (the done row's to the scratch
    page, JAX's dropped), then the absorbed attention over the gathered
    view: output and the arenas' real pages."""
    jcfg, cfg, jp, tp = model
    n_pages, page = 9, 8
    (ja, jb), (pa, pb) = _paged_arenas(jcfg, n_pages, page, 6)
    x, _, done = _slot_case(jcfg, 4, 24, 7)
    positions = np.array([10, 16, 3, 20], np.int32)
    jparams, tparams = _layer0(jp, tp)
    jout, jnew = jtr._mla_forward(
        jnp.asarray(x), jparams, jcfg, jnp.asarray(positions)[:, None],
        cache={"ckv": jnp.asarray(ja), "kr": jnp.asarray(jb),
               "bt": jnp.asarray(BT)},
        slot_positions=jnp.asarray(positions), slot_done=jnp.asarray(done))
    pos, td = _t(positions), _t(done)
    cache = {"ckv": _t(pa), "kr": _t(pb), "bt": _t(BT)}
    with torch.no_grad():
        out, new = transformer._mla_forward(
            _t(x), tparams, cfg,
            rope=transformer._rope(cfg, pos[:, None], torch.float32),
            cache=cache, slot_positions=pos.long(),
            slot_kv_len=transformer._slot_kv_len(pos, td).to(torch.int32),
            slot_done=td)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL)
    assert (out[2] == 0).all()
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(new[name][:n_pages].numpy(),
                                   np.asarray(jnew[name]), atol=1e-6)


@pytest.mark.parametrize("model", ROUTE_MODELS, indirect=True)
@pytest.mark.parametrize("paged", [False, True])
def test_chunk_verify_matches_jax(model, paged):
    """S 3 chunk queries a row over [cached latents ‖ the chunk's] at
    per-row offsets, cache read-only; a done row's exact zeros; the
    pending entry is the chunk's raw latents."""
    jcfg, cfg, jp, tp = model
    B, S = 4, 3
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    offsets = np.array([5, 0, 12, 20], np.int32)
    done = np.array([False, False, True, False])
    pos2d = offsets[:, None] + np.arange(S, dtype=np.int32)[None]
    if paged:
        (ja, jb), (pa, pb) = _paged_arenas(jcfg, 9, 8, 9)
        jcache = {"ckv": jnp.asarray(ja), "kr": jnp.asarray(jb),
                  "bt": jnp.asarray(BT)}
        cache = {"ckv": _t(pa), "kr": _t(pb), "bt": _t(BT)}
    else:
        cc, cr = _latents(jcfg, B, 24, 10)
        jcache = {"ckv": jnp.asarray(cc), "kr": jnp.asarray(cr)}
        cache = {"ckv": _t(cc), "kr": _t(cr)}
    before = {k: v.clone() for k, v in cache.items()}
    jparams, tparams = _layer0(jp, tp)
    jout, jpend = jtr._mla_forward(
        jnp.asarray(x), jparams, jcfg, jnp.asarray(pos2d), cache=jcache,
        chunk_offsets=jnp.asarray(offsets), slot_done=jnp.asarray(done))
    with torch.no_grad():
        out, pend = transformer._mla_forward(
            _t(x), tparams, cfg,
            rope=transformer._rope(cfg, _t(pos2d), torch.float32),
            cache=cache, chunk_offsets=_t(offsets), slot_done=_t(done))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL)
    assert (out[2] == 0).all()
    _assert_tree_close(pend, jpend)
    assert set(pend) == {"ckv", "kr"}
    for k in cache:
        assert torch.equal(cache[k], before[k])


def test_paged_latent_gather_matches_its_twins():
    """``ops.paged_latent_gather`` (a layout gather, no kernel) equals
    ``ref.paged_latent_gather_ref`` and JAX's entry and reference bit for
    bit, sentinel entries clamped to the last page."""
    rng = np.random.default_rng(11)
    arena = rng.standard_normal((9, 8, 16)).astype(np.float32)
    got = ops.paged_latent_gather(_t(arena), _t(BT)).numpy()
    assert got.shape == (4, 24, 16)
    np.testing.assert_array_equal(
        got, ref.paged_latent_gather_ref(_t(arena), _t(BT)).numpy())
    for mode in ("reference", "interpret"):
        np.testing.assert_array_equal(got, np.asarray(
            jax_ops.paged_latent_gather(jnp.asarray(arena), jnp.asarray(BT),
                                        mode=mode)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_ref.paged_latent_gather_ref(jnp.asarray(arena),
                                        jnp.asarray(BT))))
    np.testing.assert_array_equal(got[2, 8:], np.concatenate(
        [arena[8], arena[8]]))


# -------------------------------------------------------------- the model
@pytest.mark.parametrize("name", ["deepseek-v3-671b", SMOKE])
def test_configs_equal_the_reference(name):
    assert get_config(name) == port_config(jax_get_config(name))


@pytest.mark.parametrize("layers,start", sorted(N_PARAMS))
def test_param_shapes_equal_eval_shape(layers, start):
    """``param_shapes`` of deepseek-v3-671b (meta device, nothing drawn)
    is JAX's ``eval_shape`` leaf for leaf, whole and cut in depth; the
    2-layer cut's pieces are one dense block, one MoE block, the MTP
    head, the embedding and the head."""
    jcfg = jax_get_config("deepseek-v3-671b").replace(
        n_layers=layers, moe_layer_start=start)
    want = {p: tuple(s.shape) for p, s in tree_flatten_with_paths(
        jax.eval_shape(lambda: jax_family(jcfg).init(
            jax.random.PRNGKey(0), jcfg)))}
    got = {p: tuple(s) for p, s in tree_flatten_with_paths(
        transformer.param_shapes(port_config(jcfg)))}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == \
        N_PARAMS[(layers, start)]
    if (layers, start) == (2, 1):
        def part(prefix):
            return sum(int(np.prod(s)) for p, s in got.items()
                       if p.startswith(prefix))
        assert (part("dense_blocks."), part("moe_blocks."), part("mtp."),
                part("embed"), part("head")) == (
            583_483_392, 11_507_286_016, 686_258_176, 926_679_040,
            926_679_040)


def test_smoke_param_count():
    shapes = transformer.param_shapes(get_config(SMOKE))
    assert sum(int(np.prod(s)) for _, s in tree_flatten_with_paths(
        shapes)) == 249_216


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
def test_latent_cache_and_probes_equal_jax(model):
    """``init_cache`` holds JAX's "ckv"/"kr" latents per group; the
    paged groups, the capability probe and the layout tag are JAX's; the
    init's top-level keys (the "mtp" head on deepseek) are JAX's."""
    jcfg, cfg, _, _ = model
    want = _np(jax_family(jcfg).init_cache(jcfg, 3, MAX_LEN))
    got = transformer.init_cache(cfg, 3, MAX_LEN)
    _assert_tree_close(got, want, atol=0)
    assert paged_groups(cfg) == jax_family(jcfg).paged_groups(jcfg)
    assert serve_supported(cfg) == jax_family(jcfg).serve_supported(jcfg)
    assert transformer.slot_cache_layout(cfg) == \
        jax_family(jcfg).slot_cache_layout(jcfg) == "full-mla"
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    assert set(params) == set(jax_family(jcfg).init(jax.random.PRNGKey(0),
                                                    jcfg))


def test_mla_with_a_window_is_refused_as_jax_refuses_it():
    jcfg = _mla_only().replace(window=8)
    ok, why = serve_supported(port_config(jcfg))
    assert (ok, why) == jax_family(jcfg).serve_supported(jcfg)
    assert not ok and "no ring-buffer window" in why
    assert transformer.slot_cache_layout(port_config(jcfg)) == "unsupported"


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
def test_forward_logits_and_mtp_logits_match_jax(model):
    jcfg, cfg, jp, tp = model
    toks = lm_batch(jcfg.vocab_size, 3, 40, seed=3)
    jl, jaux = jax_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)},
                                        jcfg)
    with torch.no_grad():
        tl, taux = transformer.forward(tp, {"tokens": _t(toks)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL)
    assert set(taux) == set(jaux)
    if cfg.mtp:
        assert taux["mtp_logits"].shape == (3, 39, cfg.vocab_size)
        np.testing.assert_allclose(taux["mtp_logits"].numpy(),
                                   np.asarray(jaux["mtp_logits"]),
                                   atol=F32_ATOL)
        np.testing.assert_allclose(float(taux["moe_aux"]),
                                   float(jaux["moe_aux"]), rtol=1e-6)


def test_lm_loss_adds_the_mtp_and_aux_terms(ds):
    jcfg, cfg, jp, tp = ds
    toks = lm_batch(jcfg.vocab_size, 2, 24, seed=4)
    jl, jaux = jax_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)},
                                        jcfg)
    jloss, jm = jax_lm_loss(jl, jaux, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tl, taux = transformer.forward(tp, {"tokens": _t(toks)}, cfg)
        loss, m = lm_loss(tl, taux, {"tokens": _t(toks)}, cfg)
    assert set(m) == set(jm) == {"ce", "moe_aux", "mtp", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-6,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(loss), float(m["ce"] + m["moe_aux"]
                           + cfg.mtp_weight * m["mtp"]), rtol=1e-6)


@pytest.mark.parametrize("model", ["ds", "mla", "ds1"], indirect=True)
def test_train_step_matches_jax(model):
    """One AdamW train step at B 2 x S 16: the metrics (the MTP term
    among them) and grad_norm within 2e-5 relative, the gradients within
    F32_ATOL, the updated params within 1e-5 (a hundredth of the learning
    rate) wherever JAX's gradient exceeds 1e-6, and within the learning
    rate everywhere: the first step moves a param by lr * g / (|g| +
    eps), so a gradient within rounding of eps (1e-8) may move by any
    fraction of lr in either package."""
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
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    _assert_tree_close(seen["port"], seen["jax"])
    got = dict(tree_flatten_with_paths(to_numpy(new)))
    grads = dict(tree_flatten_with_paths(_np(seen["jax"])))
    for path, want in tree_flatten_with_paths(_np(jnew)):
        diff = np.abs(got[path] - want)
        assert diff.max() <= 1e-3, path
        assert diff[np.abs(grads[path]) > 1e-6].max(initial=0.0) <= 1e-5, \
            path


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
def test_prefill_and_decode_steps_match_jax(model):
    """Scalar prefill over (3, 20) prompts, then 4 absorbed decode steps:
    logits within F32_ATOL at every step, the latent caches at the end."""
    jcfg, cfg, jp, tp = model
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
    _assert_tree_close(tcache, jcache)


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


def _generate_each(cfg, params, reqs):
    return {r.uid: launch_serve.generate(
        cfg, params, _t(r.prompt)[None], max_new_tokens=r.max_new_tokens,
        max_len=MAX_LEN)[0].numpy() for r in reqs}


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
def test_dense_engine_matches_jax(model):
    """Greedy on the dense latent pool: tokens and counters equal JAX's
    (deepseek at capacity factor 1.25: the bucket prefills dropped
    choices); on the MLA-only config, where nothing routes, the engine
    also equals ``generate``."""
    jcfg, cfg, jp, tp = model
    jeng, want, eng, got, drops = _both(
        jcfg, cfg, jp, tp, lambda mk: _reqs(mk, cfg.vocab_size, SPECS), KW,
        KW)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert eng.cache_layout == "full-mla" and eng.pool_kind == "dense"
    if cfg.moe:
        assert drops["dropped"] > 0
        assert set(eng.pool) == {"dense", "moe"}
        assert set(eng.pool["moe"]) == {"ckv", "kr"}
    else:
        _assert_same(got, _generate_each(cfg, tp, _reqs(
            Request, cfg.vocab_size, SPECS)))


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
def test_sampled_engine_matches_jax(model):
    jcfg, cfg, jp, tp = model
    sp = SamplingParams(temperature=0.8, top_k=12, top_p=0.9, seed=5)
    jsp = JaxSamplingParams(**dataclasses.asdict(sp))
    jeng, want, eng, got, drops = _both(
        jcfg, cfg, jp, tp,
        lambda mk: _reqs(mk, cfg.vocab_size, SPECS[:4], seed0=70),
        dict(KW, sampling=jsp), dict(KW, sampling=sp))
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert (drops["dropped"] > 0) == cfg.moe


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
def test_paged_engine_with_prefix_hits_matches_jax(model):
    """A paged pool of 10 pages over six requests sharing a 16-token
    prefix (latent pages shared): tokens and counters equal JAX's; hits;
    no page stays in use; every group pages its latents."""
    jcfg, cfg, jp, tp = model
    kw = dict(KW, pool="paged", pages=10)
    jeng, want, eng, got, drops = _both(
        jcfg, cfg, jp, tp, lambda mk: _prefix_reqs(mk, cfg.vocab_size),
        kw, kw)
    _assert_same(got, want)
    assert _counters(eng) == _counters(jeng)
    assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
    assert (drops["dropped"] > 0) == cfg.moe
    for g in eng.pool.values():
        assert set(g) == {"ckv", "kr", "bt"}
        assert g["ckv"].shape[1] == 11  # 10 pages and the scratch page


def _nudged(jp, scale=1e-2, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * rng.standard_normal(
        a.shape)).astype(a.dtype), jp)


@pytest.mark.parametrize("model", ["ds", "mla"], indirect=True)
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_speculation_matches_jax(model, pool):
    """A nudged copy drafts at d 3, K 2: proposals write the draft's
    latent cache in place (no snapshot: "full-mla"), verifies attend in
    the latent space, commits write the accepted latents.  Tokens and
    counters equal JAX's speculative engine; acceptance strictly inside
    (0, 1)."""
    jcfg, cfg, jp, tp = model
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
        assert eng.pages_in_use == 0 and "bt" in eng.pool_d["dense"]


def test_reference_paged_parity_trace_is_a_capacity_effect(ds):
    """The trace of the reference's ``test_paged_mla_latent_parity``
    (capacity 2, buckets of 4): at capacity factor 1.25 paged equals dense
    in both packages and each equals JAX's, though a bucket prefill's pad
    tokens take capacity, so ``generate`` may differ; at E / K (2.0),
    where nothing drops, ``generate`` equals both pools in both packages.
    The latent pages are exact either way."""
    jcfg, cfg, jp, tp = ds
    specs = [(3, 6), (9, 2), (5, 8), (11, 4)]
    kw = dict(capacity=2, max_len=32, prefill_bucket=4, k=4)
    for cf in (1.25, 2.0):
        jc, c = jcfg.replace(capacity_factor=cf), cfg.replace(
            capacity_factor=cf)
        outs = {}
        for pool in ("dense", "paged"):
            pkw = dict(kw, pool=pool)
            jeng = JaxEngine(jc, jp, **pkw)
            outs[f"jax {pool}"] = jeng.run(_reqs(JaxRequest, c.vocab_size,
                                                 specs, seed0=40))
            eng = ContinuousBatchingEngine(c, tp, **pkw)
            with counting_drops(c) as drops:
                outs[pool] = eng.run(_reqs(Request, c.vocab_size, specs,
                                           seed0=40))
            assert eng.pool_kind == pool
            assert (drops["dropped"] > 0) == (cf == 1.25)
        for what in ("jax dense", "jax paged", "paged"):
            _assert_same(outs[what], outs["dense"])
        if cf == 2.0:
            _assert_same(outs["dense"], {r.uid: launch_serve.generate(
                c, tp, _t(r.prompt)[None], max_new_tokens=r.max_new_tokens,
                max_len=32)[0].numpy() for r in _reqs(
                    Request, c.vocab_size, specs, seed0=40)})


def test_fault_plan_on_a_dense_latent_pool_matches_jax(ds):
    """``nan@2,oom@3:2,malformed@4`` on deepseek-smoke's dense pool: the
    poisoned slot's latents quarantine it alone; outcomes, fault counters
    and every delivered token equal JAX's."""
    jcfg, cfg, jp, tp = ds
    plan = "nan@2,oom@3:2,malformed@4"
    kw = dict(KW, capacity=2)
    specs = [(4, 9), (6, 7), (5, 8), (7, 6)]
    jeng = JaxEngine(jcfg, jp, faults=JaxFaultPlan.parse(plan), **kw)
    want = jeng.run(_reqs(JaxRequest, cfg.vocab_size, specs, seed0=30))
    eng = ContinuousBatchingEngine(cfg, tp, faults=FaultPlan.parse(plan),
                                   **kw)
    got = eng.run(_reqs(Request, cfg.vocab_size, specs, seed0=30))
    _assert_same(got, want)
    assert eng.outcomes == jeng.outcomes
    assert eng.rejected == jeng.rejected
    for c in ("n_quarantined", "n_faults_injected", "n_tokens", "n_admitted",
              *COUNTERS):
        assert getattr(eng, c) == getattr(jeng, c), c
    assert eng.n_quarantined == 1 and eng.n_faults_injected == 3


def test_nan_fault_on_a_paged_latent_pool_raises_as_jax_does(ds):
    """``poison_pool`` poisons a paged group's ``k``/``v``; a latent group
    has "ckv"/"kr", so both packages raise ``KeyError('k')`` (a reference
    defect the port keeps; ROADMAP queue 3)."""
    jcfg, cfg, jp, tp = ds
    kw = dict(KW, capacity=2, pool="paged")
    with pytest.raises(KeyError, match="'k'"):
        JaxEngine(jcfg, jp, faults=JaxFaultPlan.parse("nan@1"), **kw).run(
            _reqs(JaxRequest, cfg.vocab_size, SPECS[:3]))
    with pytest.raises(KeyError, match="'k'"):
        ContinuousBatchingEngine(cfg, tp, faults=FaultPlan.parse("nan@1"),
                                 **kw).run(_reqs(Request, cfg.vocab_size,
                                                 SPECS[:3]))


def test_journal_resume_of_a_jax_crash_matches_jax(ds, tmp_path):
    """JAX's paged engine dies at dispatch 2 with a journal; the port
    resumes it on its latent groups, JAX resumes a copy: equal admissions
    step by step, tokens equal JAX's uninterrupted run."""
    jcfg, cfg, jp, tp = ds
    kw = dict(KW, pool="paged", pages=10)
    want = JaxEngine(jcfg, jp, **kw).run(_prefix_reqs(JaxRequest,
                                                      cfg.vocab_size))
    path = tmp_path / "j.jsonl"
    j = JaxJournal(str(path))
    with pytest.raises(EngineKilled):
        JaxEngine(jcfg, jp, journal=j,
                  faults=JaxFaultPlan([Fault("crash", 2)]),
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


def test_snapshot_restores_across_packages(ds, tmp_path):
    """A paged latent engine's snapshot restores in JAX and JAX's in the
    port; all three serve the same tokens."""
    jcfg, cfg, jp, tp = ds
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
    assert set(eng2.pool) == {"dense", "moe"} and eng2.cfg.name == SMOKE
    assert set(eng2.pool["moe"]) == {"ckv", "kr", "bt"}
    _assert_same(eng2.run(_reqs(Request, cfg.vocab_size, SPECS[:4],
                                seed0=80)), a)


# ----------------------------------------------------------------- growth
def _grow_pair(method):
    """deepseek-smoke (3 x 64: 1 dense, 2 MoE layers) into 4 x 128 (8
    heads, d_ff 256, the rest the smoke's); StackBERT, which only grows
    depth, into 6 x 64."""
    js = jax_get_config(SMOKE)
    if method == "stackbert":
        return js, js.replace(name="ds-smoke-deep", n_layers=6)
    return js, js.replace(name="ds-smoke-big", n_layers=4, d_model=128,
                          n_heads=8, n_kv_heads=8, d_ff=256)


def test_stackbert_refuses_width_as_jax_does():
    js = jax_get_config(SMOKE)
    jt = js.replace(name="ds-smoke-big", d_model=128, n_heads=8,
                    n_kv_heads=8, d_ff=256)
    with pytest.raises(AssertionError, match="only grows depth"):
        jgrow.build("stackbert", js, jt, rank=1)
    with pytest.raises(ValueError, match="only grows depth"):
        grow.build("stackbert", port_config(js), port_config(jt), rank=1,
                   device="cpu")


@pytest.mark.parametrize("method", jgrow.METHODS)
def test_grow_params_equals_jax(method):
    """Each method grows converted deepseek-smoke weights (MLA matrices as
    3-D slots, expert slots, the "mtp" head as global leaves widened by
    the width matrices) as JAX does, with JAX's operator params and
    trainable count."""
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
    assert "mtp" in got


def test_train_operator_follows_jax():
    """Three bare-AdamW Mango operator steps (Eq. 7) into the wider
    deepseek, the MTP and aux terms in the loss: losses within 2e-5
    relative, the trained operator within 1e-4."""
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
    """Both launchers draw deepseek-smoke's weights the same way: the
    port's ``transformer.init`` returns JAX's init at the launchers' seed
    0, converted."""
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
    assert f"transformer/full-mla ({pool} pool) on cpu served 4 requests" \
        in out
    assert _token_lines(out) == _token_lines(jout) != []


def test_train_launcher_matches_jax(monkeypatch):
    """Three steps of the train launcher at deepseek-smoke from JAX's
    weights: losses and grad norms within 1e-4 relative."""
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


# ------------------------------------------------------------------- bf16
def test_bf16_logit_error_at_most_jax():
    """ROADMAP 1.3 on deepseek-smoke: the port's bf16 route (prefill,
    then 8 absorbed decode steps fed the same tokens) is no further from
    the f32 route than JAX's bf16 route is."""
    jcfg = jax_get_config(SMOKE)
    prompts = lm_batch(jcfg.vocab_size, 2, 24, seed=17)
    port_err, jax_err, scale = bf16_logit_errors(jcfg, jax_params(jcfg),
                                                 prompts, n_steps=8)
    assert 0.0 < port_err <= jax_err, (port_err, jax_err, scale)
