"""The port's xlstm family against the JAX package (CPU).

Configs field for field and the full-width parameter count; the mLSTM in
its chunkwise and sequential forms (fresh and carried state, bucketed pads
with an all-pad chunk) and the sLSTM block against JAX's; the forward on
xlstm-1.3b-smoke and on an ("m", "s") config; prefill / decode, the
admission prefill and the slot decode with done rows bit for bit; a train
step's loss and gradients; every growth method on the 4 x 64 -> 8 x 128
pair and StackBERT's refusal; checkpoints across both packages; and the
engine against JAX's: the dense pool, the paged pool (conv tails as slot
groups, the carries dense) under page pressure, speculation with a nudged
draft on both pools, and a ``nan`` fault.

Params are made by JAX and converted with ``from_jax``; other inputs come
from seeded numpy.  f32 logits and states agree within ``F32_ATOL`` (2e-5:
the frameworks sum in different orders) unless a test says otherwise;
tokens and counters are equal.  JAX's references are built once per
module where several tests read them (JAX's xlstm compiles slowly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, bf16_logit_errors, jax_params, port_config
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.data.synthetic import lm_batch
from repro.launch.serve import generate as jax_generate
from repro.models import get_family as jax_family
from repro.models import xlstm as jx
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import Request as JaxRequest
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import paged as jpaged
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.models import get_family, paged_groups, serve_supported
from repro_torch.models import slot_cache_layout, spec_decode_supported
from repro_torch.models import xlstm
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.serve import ContinuousBatchingEngine, FaultPlan, Request
from repro_torch.serve import SpeculativeConfig, paged
from repro_torch.train.steps import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths

MAX_LEN = 48
SMOKE = "xlstm-1.3b-smoke"
XLSTM_CONFIGS = ("xlstm-1.3b", SMOKE)
N_PARAMS_13B = 3_606_139_216  # jax.eval_shape of the reference's init


def _ms_cfg():
    """One mLSTM and one sLSTM block: every recurrent state kind is
    carried (the reference's serving and paged-pool test config)."""
    return JaxConfig(name="xlstm-ms", family="xlstm", n_layers=2,
                     d_model=48, n_heads=4, n_kv_heads=4, d_ff=0,
                     vocab_size=97, proj_factor=2.0, attn_chunk=8,
                     block_pattern=("m", "s"))


def _big(jcfg):
    """The pair the reference grows: xlstm-1.3b-smoke (4 x 64) into an
    xlstm of 8 x 128 with an sLSTM block every 4."""
    return jcfg.replace(name="xlstm-smoke-big", n_layers=8, d_model=128,
                        slstm_every=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, atol=F32_ATOL):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(_np(want)))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=0,
                                   err_msg=path)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config(SMOKE)
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


@pytest.fixture(scope="module")
def ms():
    jcfg = _ms_cfg()
    jp = jax_params(jcfg)
    return jcfg, port_config(jcfg), jp, from_jax(jp)


# --------------------------------------------------------- configs, probes
@pytest.mark.parametrize("name", XLSTM_CONFIGS)
def test_xlstm_configs_equal_the_reference(name):
    assert get_config(name) == port_config(jax_get_config(name))


def test_full_width_param_shapes_equal_eval_shape():
    """``param_shapes`` (the meta-device init, nothing drawn) is JAX's
    ``eval_shape`` of xlstm-1.3b, leaf for leaf: 3,606,139,216 params."""
    jcfg = jax_get_config("xlstm-1.3b")
    want = {p: tuple(s.shape) for p, s in tree_flatten_with_paths(
        jax.eval_shape(lambda: jx.init(jax.random.PRNGKey(0), jcfg)))}
    got = {p: tuple(s) for p, s in tree_flatten_with_paths(
        xlstm.param_shapes(port_config(jcfg)))}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == N_PARAMS_13B
    types = xlstm.block_types(port_config(jcfg))
    assert types == jx.block_types(jcfg)
    assert (types.count("m"), types.count("s")) == (42, 6)


def test_family_protocol_and_probes(ms):
    jcfg, cfg, _, _ = ms
    assert get_family(cfg) is xlstm
    assert serve_supported(cfg) == jx.serve_supported(jcfg)
    assert slot_cache_layout(cfg) == "recurrent"
    assert paged_groups(cfg) == jx.paged_groups(jcfg) == {
        "m": ("slot", ("conv",)), "s": ("slot", ("conv",))}
    assert spec_decode_supported(cfg)[0]
    # the cache's tree and shapes are JAX's
    want = _np(jx.init_cache(jcfg, 3, MAX_LEN))
    got = xlstm.init_cache(cfg, 3, MAX_LEN)
    _assert_tree_close(got, want, atol=0)
    meta = xlstm.init_cache(cfg, 3, MAX_LEN, device="meta")
    assert meta["m"]["C"].device.type == "meta"


# -------------------------------------------------------------- the cells
def _cell_inputs(seed, B=2, NH=2, S=32, dh=8, plens=None, state=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, NH, S, dh)).astype(np.float32)
               for _ in range(3))
    q = q * np.float32(dh ** -0.5)
    log_i = rng.standard_normal((B, NH, S)).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(
        3.0 + rng.standard_normal((B, NH, S)).astype(np.float32)))
    if plens is not None:
        valid = (np.arange(S)[None] < np.asarray(plens)[:, None])[:, None]
        log_i = np.where(valid, log_i, -np.inf).astype(np.float32)
        log_f = np.where(valid, log_f, 0.0).astype(np.float32)
    st = None
    if state:
        st = (rng.standard_normal((B, NH, dh, dh)).astype(np.float32),
              rng.standard_normal((B, NH, dh)).astype(np.float32),
              rng.standard_normal((B, NH)).astype(np.float32))
    return (q, k, v, log_i, log_f), st


def _t(x):
    return None if x is None else (tuple(torch.tensor(a) for a in x)
                                   if isinstance(x, tuple)
                                   else torch.tensor(x))


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("plens", [None, [32, 10]])
def test_mlstm_chunkwise_and_sequential_match_jax(state, plens):
    """Both forms against JAX's, fresh and from a carried state, and over
    bucketed pads (row 1's last two chunks are all pad: the state must
    come through them unchanged); the chunkwise form also against the
    port's own sequential oracle (1e-4: the forms sum differently)."""
    ins, st = _cell_inputs(3, plens=plens, state=state)
    jst = None if st is None else tuple(jnp.asarray(a) for a in st)
    jins = [jnp.asarray(a) for a in ins]
    jh, jstate = jx.mlstm_chunkwise(*jins, jst, chunk=8)
    jhs, jstate_s = jx.mlstm_sequential(*jins, jst)
    h, s = xlstm.mlstm_chunkwise(*_t(ins), _t(st), chunk=8)
    hs, s_s = xlstm.mlstm_sequential(*_t(ins), _t(st))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_ATOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=F32_ATOL)
    for a, b in zip(s + s_s, tuple(jstate) + tuple(jstate_s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_ATOL,
                                   rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), hs.numpy(), atol=1e-4)
    if plens is not None:
        # the all-pad chunks leave row 1's state where its 10th token put
        # it: the recurrence over the first 10 positions alone
        cut = [a[:, :, :10] if a.ndim == 4 else a[..., :10] for a in ins]
        _, s10 = xlstm.mlstm_sequential(*_t(tuple(cut)), _t(st))
        for a, b in zip(s, s10):
            np.testing.assert_allclose(a[1].numpy(), b[1].numpy(),
                                       atol=F32_ATOL)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("plens", [None, [9, 4]])
def test_slstm_block_matches_jax(ms, with_cache, plens):
    """The sLSTM block (its recurrence a loop over positions) against
    JAX's: output and carried (conv, c, n, h, m), fresh or from a cache,
    with pad positions frozen."""
    jcfg, cfg, jp, tp = ms
    B, S = 2, 9
    x = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[0], jp["s_blocks"])
    tbp = {k: v if not isinstance(v, dict) else v for k, v in
           jax.tree.map(lambda a: a[0], tp["s_blocks"]).items()}
    jcache = cache = None
    if with_cache:
        rng = np.random.default_rng(6)
        full = _np(jx.init_cache(jcfg, B, MAX_LEN))["s"]
        full = {k: (rng.standard_normal(v.shape) * 0.5).astype(v.dtype)
                for k, v in full.items()}
        jcache = {k: jnp.asarray(v[0]) for k, v in full.items()}
        cache = {k: torch.from_numpy(v[0].copy()) for k, v in full.items()}
    jpl = None if plens is None else jnp.asarray(plens, jnp.int32)
    tpl = None if plens is None else torch.tensor(plens, dtype=torch.int32)
    jout, jnc = jx._slstm_block(jnp.asarray(x), jbp, jcfg, cache=jcache,
                                plens=jpl)
    out = xlstm._slstm_block(torch.from_numpy(x), tbp, cfg, cache=cache,
                             plens=tpl)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL)
    if with_cache:
        _assert_tree_close(cache, jnc)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("which", ["smoke", "ms"])
def test_forward_logits_match_jax(which, smoke, ms):
    jcfg, cfg, jp, tp = {"smoke": smoke, "ms": ms}[which]
    toks = lm_batch(jcfg.vocab_size, 2, 32, seed=7)
    jl, _ = jx.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, aux = xlstm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL)
    assert aux == {"moe_aux": 0.0}


def test_prefill_and_decode_steps_match_jax(smoke):
    """Prefill (two chunks) then 4 decode steps: logits and every cache
    leaf within F32_ATOL of JAX's; the sequential prefill agrees with the
    chunkwise one (1e-4)."""
    jcfg, cfg, jp, tp = smoke
    toks = lm_batch(jcfg.vocab_size, 2, 32, seed=8)
    jl, jc = jx.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                        jx.init_cache(jcfg, 2, MAX_LEN))
    tc = xlstm.init_cache(cfg, 2, MAX_LEN)
    tl, tc = xlstm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL)
    _assert_tree_close(tc, jc)
    sl, sc = xlstm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                           xlstm.init_cache(cfg, 2, MAX_LEN),
                           chunkwise=False)
    np.testing.assert_allclose(sl.numpy(), tl.numpy(), atol=1e-4)
    _assert_tree_close(sc, jc, atol=1e-4)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(4):
        jl, jc = jx.decode_step(jp, jnp.asarray(nxt), 32 + i, jc, jcfg)
        tl, tc = xlstm.decode_step(tp, torch.from_numpy(nxt), 32 + i, tc,
                                   cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=F32_ATOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    _assert_tree_close(tc, jc)


def test_prefill_full_and_last_per_row_with_padded_buckets(ms):
    """A bucket of 16 with true lengths 16, 5 and 11: JAX's per-position
    logits at the real positions, ``prefill_last`` at each row's last,
    and the carried state after each row's REAL prompt."""
    jcfg, cfg, jp, tp = ms
    plens = np.array([16, 5, 11], np.int32)
    toks = lm_batch(jcfg.vocab_size, 3, 16, seed=9)
    jl, jc = jx.prefill_full(jp, {"tokens": jnp.asarray(toks),
                                  "plens": jnp.asarray(plens)}, jcfg,
                             jx.init_cache(jcfg, 3, MAX_LEN))
    tl, tc = xlstm.prefill_full(tp, {"tokens": torch.from_numpy(toks),
                                     "plens": torch.from_numpy(plens)}, cfg,
                                xlstm.init_cache(cfg, 3, MAX_LEN))
    for b, n in enumerate(plens):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   atol=F32_ATOL)
    _assert_tree_close(tc, jc)
    last, tc2 = xlstm.prefill_last(tp, torch.from_numpy(toks),
                                   torch.from_numpy(plens), cfg,
                                   xlstm.init_cache(cfg, 3, MAX_LEN))
    np.testing.assert_allclose(
        last.numpy(), np.asarray(jl)[np.arange(3), plens - 1], atol=F32_ATOL)
    _assert_tree_close(tc2, jc)
    # the head-less admission of a speculative draft fills the same state
    tc3 = xlstm.prefill_cache(tp, torch.from_numpy(toks), cfg,
                              xlstm.init_cache(cfg, 3, MAX_LEN),
                              plens=torch.from_numpy(plens))
    _assert_tree_close(tc3, jc)


def test_decode_step_slots_match_jax_and_done_rows_stay_bit_identical(ms):
    """Slot decode with a done row: logits and the cache match JAX's; the
    done row's every leaf, and a whole all-done step, leave the pool bit
    for bit."""
    jcfg, cfg, jp, tp = ms
    B, S = 3, 12
    plens = np.array([12, 4, 7], np.int32)
    toks = lm_batch(jcfg.vocab_size, B, S, seed=10)
    _, jc = jx.prefill_full(jp, {"tokens": jnp.asarray(toks),
                                 "plens": jnp.asarray(plens)}, jcfg,
                            jx.init_cache(jcfg, B, MAX_LEN))
    tc = from_jax(_np(jc))
    done = np.array([False, True, False])
    rng = np.random.default_rng(11)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        before = jax.tree.map(lambda t: t.clone(), tc)
        jl, jc = jx.decode_step_slots(jp, jnp.asarray(nxt),
                                      jnp.asarray(plens), jc, jcfg,
                                      done=jnp.asarray(done))
        tl, tc = xlstm.decode_step_slots(tp, torch.from_numpy(nxt),
                                         torch.from_numpy(plens), tc, cfg,
                                         done=torch.from_numpy(done))
        np.testing.assert_allclose(tl[~done].numpy(), np.asarray(jl)[~done],
                                   atol=F32_ATOL)
        for leaf, old in zip(jax.tree.leaves(tc), jax.tree.leaves(before)):
            assert torch.equal(leaf[:, 1], old[:, 1])
    _assert_tree_close(tc, jc)
    before = jax.tree.map(lambda t: t.clone(), tc)
    xlstm.decode_step_slots(tp, torch.zeros(B, dtype=torch.int32),
                            torch.from_numpy(plens), tc, cfg,
                            done=torch.ones(B, dtype=torch.bool))
    for leaf, old in zip(jax.tree.leaves(tc), jax.tree.leaves(before)):
        assert torch.equal(leaf, old)


def test_train_step_loss_and_grads_equal_jax(ms):
    """One train step of the ("m", "s") config at B 2 x S 16 (two chunks
    of 8): loss, ce and grad_norm equal JAX's (2e-5 relative), and the
    gradients seen by ``grad_transform`` equal JAX's (F32_ATOL)."""
    jcfg, cfg, jp, tp = ms
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
    _, _, jm = jstep(jp, jinit(jp), {"tokens": jnp.asarray(toks)},
                     jnp.int32(1))
    opt = OptimizerConfig(lr=1e-3)
    init, _ = make_optimizer(opt)
    params = from_jax(jp)
    step = make_train_step(cfg, opt, grad_transform=keep("port"))
    _, _, tm = step(params, init(params), {"tokens": torch.from_numpy(toks)},
                    1)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    _assert_tree_close(seen["port"], seen["jax"])


def test_train_launcher_trains_xlstm():
    """The port's train launcher takes xlstm-1.3b-smoke (two chunks a
    sequence): finite losses, params on the CPU as asked."""
    from repro_torch.launch import train as launch_train

    logs = []
    params, hist = launch_train.train(SMOKE, steps=2, batch=2, seq=32,
                                      log_every=1, device="cpu",
                                      log_fn=logs.append)
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert params["m_blocks"]["w_q"].device.type == "cpu"


# ----------------------------------------------------------------- growth
@pytest.mark.parametrize("method", ["mango", "bert2bert", "ligo", "net2net"])
def test_grow_params_equals_jax(method):
    """Each width method grows converted xlstm-1.3b-smoke weights into the
    8 x 128 xlstm as JAX does, with JAX's operator params and trainable
    count."""
    js = jax_get_config(SMOKE)
    jt = _big(js)
    src = jax_params(js, seed=1)
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    want = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build(method, port_config(js), port_config(jt), rank=1,
                        device="cpu")
    op_params = from_jax(_np(jop))
    got = grow.grow_params(gop, op_params, from_jax(src))
    _assert_tree_close(got, want)
    assert grow.operator_param_count(gop, op_params) == \
        jgrow.operator_param_count(jgop, jop)
    assert gop.trainable == jgop.trainable


def test_stackbert_refuses_the_width_pair_as_jax_does():
    js = jax_get_config(SMOKE)
    jt = _big(js)
    with pytest.raises(AssertionError, match="StackBERT only grows depth"):
        jgrow.build("stackbert", js, jt, rank=1)
    with pytest.raises(ValueError, match="StackBERT only grows depth"):
        grow.build("stackbert", port_config(js), port_config(jt), rank=1,
                   device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, smoke, writer):
    """xlstm params saved by one package load in the other bit for bit."""
    _, _, jp, tp = smoke
    if writer == "jax":
        jax_save(str(tmp_path), 2, jp, extra={"arch": SMOKE})
        got, step, extra = load_checkpoint(
            str(tmp_path), jax.tree.map(lambda t: torch.zeros_like(t), tp))
        assert (step, extra) == (2, {"arch": SMOKE})
        for (pa, a), (pb, b) in zip(tree_flatten_with_paths(got),
                                    tree_flatten_with_paths(tp)):
            assert pa == pb and torch.equal(a, b), pa
    else:
        save_checkpoint(str(tmp_path), 3, tp, extra={"arch": SMOKE})
        got, step, _ = jax_load(str(tmp_path),
                                jax.tree.map(np.zeros_like, jp))
        assert step == 3
        for (pa, a), (pb, b) in zip(tree_flatten_with_paths(_np(got)),
                                    tree_flatten_with_paths(jp)):
            assert pa == pb and np.array_equal(a, b), pa


# ------------------------------------------------------------- the engine
def _reqs(make, vocab, specs, seed0=50):
    return [make(uid=i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _generate_each(cfg, params, reqs):
    return {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens,
                            max_len=MAX_LEN)[0].numpy() for r in reqs}


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid]),
                                      np.asarray(want[uid]),
                                      err_msg=f"uid {uid}")


COUNTERS = ("n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_prefix_hits", "n_prefix_misses", "n_spec_proposed",
            "n_spec_accepted", "n_quarantined", "n_faults_injected")
SPECS = [(3, 6), (9, 2), (5, 8), (12, 4), (4, 7), (20, 5)]


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


def _stepped(eng, reqs):
    for r in reqs:
        eng.submit(r)
    trace = []
    while eng.waiting or eng.active:
        eng.step()
        trace.append(sorted(s.req.uid for s in eng.active.values()))
    return trace


@pytest.fixture(scope="module")
def ms_dense_run(ms):
    """JAX's dense engine over SPECS at capacity 2, K 4."""
    jcfg, _, jp, _ = ms
    jeng = JaxEngine(jcfg, jp, capacity=2, max_len=MAX_LEN,
                     prefill_bucket=4, k=4)
    return jeng, jeng.run(_reqs(JaxRequest, jcfg.vocab_size, SPECS))


def test_engine_matches_jax_engine_and_generate(ms, ms_dense_run):
    jcfg, cfg, jp, tp = ms
    jeng, want = ms_dense_run
    eng = ContinuousBatchingEngine(cfg, tp, capacity=2, max_len=MAX_LEN,
                                   prefill_bucket=4, k=4)
    got = eng.run(_reqs(Request, cfg.vocab_size, SPECS))
    _assert_same(got, want)
    _assert_same(got, _generate_each(cfg, tp, _reqs(Request, cfg.vocab_size,
                                                    SPECS)))
    assert _counters(eng) == _counters(jeng)
    assert eng.cache_layout == "recurrent" and eng.pool_kind == "dense"
    assert len({tuple(t) for t in got.values()}) == len(SPECS)


def test_paged_engine_under_page_pressure_matches_jax(ms, ms_dense_run):
    """Both blocks page their conv tails as slot groups (one page a slot,
    the carries dense beside them); 2 pages for a capacity of 3 make
    admissions wait.  Admission trace, tokens and counters equal JAX's
    paged engine; tokens equal the dense pool's; no page is left in
    use."""
    jcfg, cfg, jp, tp = ms
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=4, k=4,
              pool="paged", pages=2)
    jeng, eng = JaxEngine(jcfg, jp, **kw), ContinuousBatchingEngine(cfg, tp,
                                                                    **kw)
    jtrace = _stepped(jeng, _reqs(JaxRequest, jcfg.vocab_size, SPECS))
    trace = _stepped(eng, _reqs(Request, cfg.vocab_size, SPECS))
    assert trace == jtrace
    _assert_same(eng.finished, jeng.finished)
    eng.run(), jeng.run()  # apply the last evictions
    assert _counters(eng) == _counters(jeng)
    assert eng.pages_in_use == 0 and eng.pages_highwater == 2
    assert eng.pool_kind == "paged" and eng.pool_fallback_reason is None
    groups = [g for g in eng.pool.values() if "bt" in g]
    assert len(groups) == 2 and all(len(g) > 2 for g in groups)
    assert eng.pool["m"]["conv"].shape[1] == 3  # 2 pages + the scratch page
    assert eng.pool["m"]["C"].shape[1] == 3  # dense per slot
    _assert_same(eng.finished, ms_dense_run[1])


def test_paged_pool_geometry_scatter_and_evict_match_jax(ms):
    """``build_paged_pool`` lays the slot groups out as JAX's does (plus
    the scratch page) with the carries dense inside them; ``admit_scatter``
    and ``evict_clear`` write the dense leaves' slots and the tails'
    pages as JAX's do."""
    jcfg, cfg, jp, tp = ms
    jpool, jmeta = jpaged.build_paged_pool(jax_family(jcfg), jcfg, 3,
                                           MAX_LEN, pages=4)
    pool, meta = paged.build_paged_pool(xlstm, cfg, 3, MAX_LEN, pages=4)
    assert (meta.page, meta.nblk, meta.n_pages) == (
        jmeta.page, jmeta.nblk, jmeta.n_pages) == (0, 1, 4)
    assert [(g.path, g.kind, g.leaves, g.page, g.nblk) for g in
            meta.groups] == [(g.path, g.kind, g.leaves, g.page, g.nblk)
                             for g in jmeta.groups]
    assert paged.pages_needed(30, 100, meta) == jpaged.pages_needed(
        30, 100, jmeta) == 1

    def tails(pool_, key, name):
        t = pool_[key][name]
        return t[:, :4] if name == "conv" else t  # drop the scratch page

    for key, grp in jpool.items():
        assert set(pool[key]) == set(grp)
        for name, leaf in grp.items():
            assert tuple(tails(pool, key, name).shape) == leaf.shape
    plens = np.array([9, 3], np.int32)
    toks = lm_batch(jcfg.vocab_size, 2, 9, seed=15)
    _, jrows = jx.prefill_full(jp, {"tokens": jnp.asarray(toks),
                                    "plens": jnp.asarray(plens)}, jcfg,
                               jx.init_cache(jcfg, 2, MAX_LEN))
    rows = from_jax(_np(jrows))
    bt_rows = np.array([[3], [1]], np.int32)
    jpool = jpaged.admit_scatter(jpool, jrows, jnp.asarray([2, 0]),
                                 jnp.asarray(bt_rows), jmeta)
    paged.admit_scatter(pool, rows, torch.tensor([2, 0]),
                        torch.from_numpy(bt_rows), meta)
    for key in jpool:
        for name, leaf in jpool[key].items():
            np.testing.assert_array_equal(tails(pool, key, name).numpy(),
                                          np.asarray(leaf),
                                          err_msg=f"{key}/{name}")
    jpool = jpaged.evict_clear(jpool, jnp.asarray([2, 3]),
                               jnp.asarray([3, 4]), jmeta)
    paged.evict_clear(pool, torch.tensor([2]), torch.tensor([3]), meta)
    for key in jpool:
        for name, leaf in jpool[key].items():
            np.testing.assert_array_equal(tails(pool, key, name).numpy(),
                                          np.asarray(leaf))


def _nudged(jp, scale=1e-2, seed=1):
    """A draft that almost agrees with the target: every leaf moved by
    ``scale`` times seeded standard normals (numpy, so both packages draft
    with the same weights)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * rng.standard_normal(
        a.shape)).astype(a.dtype), jp)


SPEC_SPECS = [(4, 8), (7, 10), (11, 6)]


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_speculation_with_a_nudged_draft_matches_jax(smoke, pool):
    """xlstm-1.3b-smoke drafted for by a nudged copy (d 2, K 2, capacity
    2), on the dense pool and on a paged pool of 3 pages shared by target
    and draft: tokens equal JAX's speculative engine and sequential
    ``generate``; counters equal JAX's; acceptance strictly inside (0,
    1), so rows commit partial chunks and roll back mid-chunk."""
    jcfg, cfg, jp, tp = smoke
    jd = _nudged(jp)
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2)
    if pool == "paged":
        kw.update(pool="paged", pages=3)
    jeng = JaxEngine(jcfg, jp, speculative=JaxSpeculativeConfig(jcfg, jd,
                                                                d=2), **kw)
    want = jeng.run(_reqs(JaxRequest, jcfg.vocab_size, SPEC_SPECS, 60))
    eng = ContinuousBatchingEngine(cfg, tp, speculative=SpeculativeConfig(
        cfg, from_jax(jd), d=2), **kw)
    got = eng.run(_reqs(Request, cfg.vocab_size, SPEC_SPECS, 60))
    _assert_same(got, want)
    _assert_same(got, _generate_each(cfg, tp, _reqs(
        Request, cfg.vocab_size, SPEC_SPECS, 60)))
    assert _counters(eng) == _counters(jeng)
    assert 0.0 < eng.acceptance_rate < 1.0
    assert eng.pool_kind == pool and eng.n_spec_fallbacks == 0
    if pool == "paged":
        assert eng.pages_in_use == 0
        assert "bt" in eng.pool_d["m"] and "bt" in eng.pool_d["s"]


def test_nan_fault_dense_matches_jax_and_paged_raises_as_jax_does(
        ms, ms_dense_run):
    """``nan@1`` on the dense pool poisons a live slot's every float leaf
    (conv tails, C/n/m, sLSTM carries), as JAX's engine does: the same
    outcomes, counters and survivors' tokens.  On a paged pool both
    packages raise ``KeyError('k')``: ``poison_pool`` poisons a paged
    group's ``k``/``v``, and an xlstm slot group has neither (a
    reference defect the port keeps)."""
    jcfg, cfg, jp, tp = ms
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
    jeng = JaxEngine(jcfg, jp, faults=JaxFaultPlan.parse("nan@1"), **kw)
    want = jeng.run(_reqs(JaxRequest, jcfg.vocab_size, SPECS))
    eng = ContinuousBatchingEngine(cfg, tp, faults=FaultPlan.parse("nan@1"),
                                   **kw)
    got = eng.run(_reqs(Request, cfg.vocab_size, SPECS))
    _assert_same(got, want)
    assert eng.outcomes == jeng.outcomes
    assert _counters(eng) == _counters(jeng)
    assert eng.n_quarantined == 1
    clean = ms_dense_run[1]
    for uid, o in eng.outcomes.items():
        if o == "finished":
            np.testing.assert_array_equal(got[uid], clean[uid])
    kw.update(pool="paged")
    jpaged_eng = JaxEngine(jcfg, jp, faults=JaxFaultPlan.parse("nan@1"),
                           **kw)
    with pytest.raises(KeyError, match="'k'"):
        jpaged_eng.run(_reqs(JaxRequest, jcfg.vocab_size, SPECS))
    paged_eng = ContinuousBatchingEngine(cfg, tp,
                                         faults=FaultPlan.parse("nan@1"),
                                         **kw)
    with pytest.raises(KeyError, match="'k'"):
        paged_eng.run(_reqs(Request, cfg.vocab_size, SPECS))


@pytest.mark.parametrize("extra,pool", [
    ([], "dense"), (["--pool", "paged", "--pages", "2"], "paged"),
    (["--speculate", "--draft", SMOKE, "--spec-d", "2"], "dense")])
def test_serve_launcher_serves_xlstm_on_cpu(capsys, extra, pool):
    launch_serve.main(["--arch", SMOKE, "--engine", "continuous", "--batch",
                       "3", "--prompt-len", "12", "--gen", "4",
                       "--capacity", "2", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert f"xlstm/recurrent ({pool} pool)" in out
    assert "served 3 requests / 12 tokens" in out


def test_serve_launcher_names_xlstm_as_jax_does():
    """The servability refusal lists the families as JAX's launcher does,
    xlstm among them (a griffin with attention blocks and no window is
    refused)."""
    cfg = get_config("griffin-micro").replace(name="no-window", window=0)
    with pytest.raises(SystemExit) as e:
        launch_serve.require_servable(cfg)
    assert "xlstm       — mLSTM/sLSTM recurrent state." in str(e.value)
    assert "require cfg.window" in str(e.value)


# ----------------------------------------------------------------- bf16
@pytest.mark.parametrize("name", ["recurrentgemma-2b-smoke", SMOKE])
def test_bf16_logit_error_at_most_jax(name):
    """ROADMAP 1.3: on the same bf16-cast weights, the port's bf16 route
    (prefill, then 8 decode steps fed the same tokens) is no further from
    the f32 route than JAX's bf16 route is."""
    jcfg = jax_get_config(name)
    prompts = lm_batch(jcfg.vocab_size, 2, 24, seed=17)
    port_err, jax_err, scale = bf16_logit_errors(jcfg, jax_params(jcfg),
                                                 prompts, n_steps=8)
    assert 0.0 < port_err <= jax_err, (port_err, jax_err, scale)
