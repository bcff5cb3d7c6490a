"""The port's windowed transformer against the JAX package (CPU).

A config with ``window`` serves from ring-buffer slot caches: the plain
ring layout of the paged chunk verify against JAX's oracle and Pallas
kernel in interpret mode, the ring routes of the model (forward, prefill
and decode, the ring fill of a bucketed admission, slot decode and
verify/commit on the dense and the paged pool), the ring prefix cache's
page copies, and the engine -- dense, paged, with ring prefix hits,
speculative on both pools, against JAX's Pallas kernels, sampled --
against JAX's engine and the port's ``generate``.  Then Mango growth and
a train step of a windowed config.  Logits within 2e-5; tokens and
engine counters equal.  The CUDA kernels are held against the plain
versions in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    F32_ATOL,
    both_params,
    check_sampled,
    jax_params,
    port_config,
    sampled_replay,
    tiny_gqa,
)
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import get_family as jax_family
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import paged as jpaged
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import generate
from repro_torch.models import attention, transformer
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
    SpeculativeConfig,
)
from repro_torch.serve import paged
from repro_torch.train.steps import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths

MAX_LEN = 32


def _window_cfg(window=8, name="win-paged"):
    """The reference's windowed serving config (window 8: a ring of 8, one
    page of 8; window 9: a ring of 16, two pages, the smallest ring that
    keeps an intact page for prefix sharing)."""
    return JaxConfig(name=name, n_layers=2, d_model=48, n_heads=4,
                     n_kv_heads=2, d_ff=96, vocab_size=97, window=window,
                     attn_chunk=8)


@pytest.fixture(scope="module")
def win8():
    jcfg = _window_cfg(8)
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


@pytest.fixture(scope="module")
def win9():
    jcfg = _window_cfg(9, "win9-paged")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


@pytest.fixture(scope="module")
def qwen_win():
    """qwen3-0.6b-smoke with window 8 (RoPE, q/k norms, GQA)."""
    jcfg = jax_get_config("qwen3-0.6b-smoke").replace(window=8)
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


def _reqs(make, vocab, specs, seed0=50, uid0=0):
    return [make(uid=uid0 + i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _same_prompt(make, prompt, n, gen=6, uid0=0):
    return [make(uid=uid0 + i, prompt=prompt.copy(), max_new_tokens=gen)
            for i in range(n)]


def _generate_each(cfg, params, reqs, max_len=MAX_LEN):
    return {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens,
                            max_len=max_len)[0].numpy() for r in reqs}


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"uid {uid}")


COUNTERS = ("n_prefix_hits", "n_prefix_misses", "n_prefix_stalls",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens",
            "n_spec_proposed", "n_spec_accepted")


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


def _engines(jcfg, jp, tcfg, tp, **kw):
    kw = dict(dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4), **kw)
    return JaxEngine(jcfg, jp, **kw), ContinuousBatchingEngine(tcfg, tp, **kw)


# ------------------------------------------- the plain ring verify (paged)
def test_ring_key_positions_and_mask_match_jax():
    """The ring's key positions at per-row lengths that wrap several
    times (the plain versions' ``_ring_kpos``, the model's
    ``ring_positions_rows``) and the verify's mask equal JAX's
    ``chunk_verify_kpos(ring=True)`` / ``chunk_verify_mask``."""
    cap, S, window = 16, 5, 9
    offsets = np.array([-1, 0, 3, 15, 16, 17, 40, 63, 100], np.int32)
    jk = np.asarray(jattn.chunk_verify_kpos(jnp.asarray(offsets), cap, S,
                                            ring=True))
    off = torch.from_numpy(offsets)
    steps = torch.arange(S, dtype=torch.int32)[None]
    for kpos_cache in (ref._ring_kpos(off, cap),
                       attention.ring_positions_rows(off, cap)):
        kpos = torch.cat([kpos_cache, off[:, None] + steps], 1)
        np.testing.assert_array_equal(kpos.numpy(), jk)
    jm = np.asarray(jattn.chunk_verify_mask(jnp.asarray(offsets),
                                            jnp.asarray(jk), S,
                                            window=window))
    kpos = torch.from_numpy(np.array(jk))
    qpos = off[:, None] + steps
    m = ((kpos[:, None] >= 0) & (kpos[:, None] <= qpos[:, :, None])
         & (kpos[:, None] > qpos[:, :, None] - window))
    np.testing.assert_array_equal(m.numpy(), jm)


def _ring_arena(seed, B, KV, hd, n_pages, page, nblk, dtype):
    """Random arenas and tables: a seeded page permutation per row, one
    row's last block the sentinel (a ring the row never filled)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    perm = rng.permutation(n_pages)
    bt = np.stack([np.roll(perm, 3 * b)[:nblk] for b in range(B)]).astype(
        np.int32)
    bt[2, -1] = n_pages
    return rnd, bt, rnd(n_pages, page, KV, hd), rnd(n_pages, page, KV, hd)


@pytest.mark.parametrize("G,S,window,dtype", [
    (1, 3, None, "float32"), (2, 5, 9, "float32"), (4, 5, 8, "float32"),
    (2, 17, 9, "float32"), (2, 5, 9, "bfloat16")])
def test_paged_chunk_ring_plain_matches_jax_ref_and_pallas(G, S, window,
                                                          dtype):
    """The ring layout of the paged verify (cap = nblk * page = 32):
    offsets -1 (done: exact zeros), 0, inside the first lap, at the
    wrap and two, three and four laps in, through permuted tables with a
    sentinel entry; the plain version equals JAX's oracle and its Pallas
    kernel in interpret mode (f32 within 1e-5, bf16 within one output
    rounding)."""
    B, KV, hd, n_pages, page, nblk = 8, 2, 16, 11, 8, 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rnd, bt, ck, cv = _ring_arena(G * 7 + S, B, KV, hd, n_pages, page, nblk,
                                  jdt)
    q, k, v = rnd(B, S, G * KV, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    offsets = np.array([-1, 0, 13, 31, 32, 70, 100, 131], np.int32)
    done = np.zeros(B, bool)
    done[1] = True
    jin = [jnp.asarray(a) for a in (q, ck, cv, bt, k, v)]
    want = [jops.paged_chunk_verify_attention(
        *jin, jnp.asarray(offsets), ring=True, window=window, mode=m,
        done=jnp.asarray(done)) for m in ("reference", "interpret")]

    def to_t(a):
        t = torch.from_numpy(np.asarray(a, np.float32))
        return t.bfloat16() if dtype == "bfloat16" else t
    got = ops.paged_chunk_verify_attention(
        *(to_t(a) for a in (q, ck, cv)), torch.from_numpy(bt),
        *(to_t(a) for a in (k, v)), torch.from_numpy(offsets), ring=True,
        window=window, done=torch.from_numpy(done))
    assert (got[0] == 0).all() and (got[1] == 0).all()
    tol = (dict(atol=5e-3, rtol=1e-2) if dtype == "bfloat16"
           else dict(atol=1e-5, rtol=0))
    for w in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("name", ["qwen", "gqa"])
def test_windowed_forward_matches_jax(qwen_win, name):
    """The windowed forward (plain windowed attention, RoPE or learned
    positions) over a sequence three windows long equals JAX's."""
    if name == "qwen":
        jcfg, cfg, jp, tp = qwen_win
    else:
        jcfg = tiny_gqa(window=6)
        jp, tp = both_params(jcfg, randomize=True)
        cfg = port_config(jcfg)
    toks = lm_batch(cfg.vocab_size, 2, 24, seed=3)
    want, _ = jax_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)},
                                       jcfg)
    got, _ = transformer.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_local_window_prefill_decode_matches_forward():
    """The reference's local-window serving invariant: prefill 8 tokens,
    then decode 8 more into a ring of 8 (window 6: the ring wraps);
    every step's logits equal the full forward's and JAX's decode's."""
    jcfg = JaxConfig(name="w", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=1, d_ff=128, vocab_size=97, window=6,
                     attn_chunk=8)
    jp, tp = both_params(jcfg)
    cfg = port_config(jcfg)
    jfam = jax_family(jcfg)
    toks = lm_batch(cfg.vocab_size, 2, 16, seed=1)
    full, _ = transformer.forward(tp, {"tokens": torch.from_numpy(toks)},
                                  cfg)
    cache = transformer.init_cache(cfg, 2, 16)
    jcache = jfam.init_cache(jcfg, 2, 16)
    assert cache["dense"]["k"].shape == jcache["dense"]["k"].shape
    assert cache["dense"]["k"].shape[2] == 8  # pad_cache_len(6)
    got, cache = transformer.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :8])}, cfg, cache)
    want, jcache = jfam.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])},
                                jcfg, jcache)
    np.testing.assert_allclose(got.numpy(), full[:, 7].numpy(),
                               atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    for t in range(8, 16):
        tok = torch.from_numpy(toks[:, t])
        got, cache = transformer.decode_step(tp, tok, t, cache, cfg)
        want, jcache = jfam.decode_step(jp, jnp.asarray(toks[:, t]),
                                        jnp.int32(t), jcache, jcfg)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   atol=F32_ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL, err_msg=f"step {t}")
    np.testing.assert_allclose(cache["dense"]["k"].numpy(),
                               np.asarray(jcache["dense"]["k"]),
                               atol=F32_ATOL)


def _ring_rows(jcfg, cfg, jp, tp, plens, bucket, seed):
    """JAX's and the port's admission prefill of tail-padded prompts of
    ``plens`` into ring scratch rows: (logits at each true last position,
    JAX's rows, the port's rows)."""
    B = len(plens)
    toks = np.zeros((B, bucket), np.int32)
    for b, p in enumerate(plens):
        toks[b, :p] = lm_batch(cfg.vocab_size, 1, p, seed=seed + b)[0]
    pl = np.asarray(plens, np.int32)
    jrows = jax_family(jcfg).init_cache(jcfg, B, MAX_LEN)
    jlog, jrows = jax_family(jcfg).prefill_full(
        jp, {"tokens": jnp.asarray(toks), "plens": jnp.asarray(pl)}, jcfg,
        jrows)
    rows = transformer.init_cache(cfg, B, MAX_LEN)
    got, rows = transformer.prefill_last(tp, torch.from_numpy(toks),
                                         torch.from_numpy(pl), cfg, rows)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlog)[np.arange(B), pl - 1], atol=F32_ATOL)
    return jrows, rows


def test_ring_admission_prefill_fills_each_row_from_its_length(qwen_win):
    """A bucketed admission prefill (prompts 3..20 padded to 20) fills
    each row's ring of 8 from its true length, bit for bit as JAX's ring
    fill (positions past the prompt never land); ``prefill_cache`` (the
    draft's) fills the same rings."""
    jcfg, cfg, jp, tp = qwen_win
    plens = [3, 8, 9, 17, 20]
    jrows, rows = _ring_rows(jcfg, cfg, jp, tp, plens, 20, seed=30)
    assert rows["dense"]["k"].shape == jrows["dense"]["k"].shape
    for name in ("k", "v"):
        np.testing.assert_allclose(rows["dense"][name].numpy(),
                                   np.asarray(jrows["dense"][name]),
                                   atol=F32_ATOL)
    again = transformer.init_cache(cfg, len(plens), MAX_LEN)
    toks = np.zeros((len(plens), 20), np.int32)
    for b, p in enumerate(plens):
        toks[b, :p] = lm_batch(cfg.vocab_size, 1, p, seed=30 + b)[0]
    transformer.prefill_cache(tp, torch.from_numpy(toks), cfg, again,
                              plens=torch.tensor(plens, dtype=torch.int32))
    assert torch.equal(again["dense"]["k"], rows["dense"]["k"])


def _paged_rows(cfg, rows, n_pages, bt_rows, capacity):
    pool, meta = paged.build_paged_pool(transformer, cfg, capacity, MAX_LEN,
                                        pages=n_pages)
    n = bt_rows.shape[0]
    paged.admit_scatter(pool, {"dense": {k: v[:, :n] for k, v in
                                         rows["dense"].items()}},
                        torch.arange(n), torch.from_numpy(bt_rows), meta)
    return pool, meta


def _jax_paged_rows(jcfg, jrows, n_pages, bt_rows, capacity):
    jpool, jmeta = jpaged.build_paged_pool(jax_family(jcfg), jcfg, capacity,
                                           MAX_LEN, pages=n_pages)
    n = bt_rows.shape[0]
    jpool = jpaged.admit_scatter(jpool, jrows, jnp.arange(n, dtype=jnp.int32),
                                 jnp.asarray(bt_rows), jmeta)
    return jpool


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_ring_slot_decode_matches_jax(win9, pool):
    """Slot decode over rings of 16 (window 9; on the paged pool two pages
    a row): 12 steps from admitted rows at lengths 3..20 wrap every ring;
    logits (a done row aside) and the rings equal JAX's."""
    jcfg, cfg, jp, tp = win9
    plens = [3, 11, 16, 20]
    jrows, rows = _ring_rows(jcfg, cfg, jp, tp, plens, 20, seed=40)
    if pool == "paged":
        bt_rows = np.array([[4, 1], [0, 6], [7, 2], [3, 5]], np.int32)
        cache, _ = _paged_rows(cfg, rows, 8, bt_rows, 4)
        jcache = _jax_paged_rows(jcfg, jrows, 8, bt_rows, 4)
    else:
        cache, jcache = rows, jrows
    jfam = jax_family(jcfg)
    rng = np.random.default_rng(5)
    positions = np.asarray(plens, np.int32)
    done = np.array([False, False, True, False])
    for step in range(12):
        toks = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
        want, jcache = jfam.decode_step_slots(
            jp, jnp.asarray(toks), jnp.asarray(positions), jcache, jcfg,
            done=jnp.asarray(done))
        got, cache = transformer.decode_step_slots(
            tp, torch.from_numpy(toks), torch.from_numpy(positions), cache,
            cfg, done=torch.from_numpy(done))
        np.testing.assert_allclose(got[~torch.from_numpy(done)].numpy(),
                                   np.asarray(want)[~done], atol=F32_ATOL,
                                   err_msg=f"step {step}")
        positions = positions + np.where(done, 0, 1).astype(np.int32)
    n = 8 if pool == "paged" else None
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["dense"][name][:, :n].numpy(),
                                   np.asarray(jcache["dense"][name]),
                                   atol=F32_ATOL)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_ring_verify_and_commit_match_jax(win8, pool):
    """A verify chunk of 4 over rings of 8 at wrapped lengths (one row
    done): logits equal JAX's and the rings stay untouched; the commit of
    0..4 accepted positions writes their ring slots where JAX's does, and
    a row committing nothing keeps its ring bit for bit."""
    jcfg, cfg, jp, tp = win8
    plens = [5, 8, 13, 19]
    jrows, rows = _ring_rows(jcfg, cfg, jp, tp, plens, 20, seed=60)
    if pool == "paged":
        bt_rows = np.array([[3], [0], [2], [1]], np.int32)
        cache, _ = _paged_rows(cfg, rows, 4, bt_rows, 4)
        jcache = _jax_paged_rows(jcfg, jrows, 4, bt_rows, 4)
    else:
        cache, jcache = rows, jrows
    jfam = jax_family(jcfg)
    chunk = lm_batch(cfg.vocab_size, 4, 4, seed=61)
    positions = np.asarray(plens, np.int32)
    done = np.array([False, True, False, False])
    before = {k: v.clone() for k, v in cache["dense"].items()}
    want, jpend = jfam.verify_step_slots(jp, jnp.asarray(chunk),
                                         jnp.asarray(positions), jcache,
                                         jcfg, done=jnp.asarray(done))
    got, pend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions), cache,
        cfg, done=torch.from_numpy(done))
    live = ~done
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=F32_ATOL)
    for k in before:
        assert torch.equal(cache["dense"][k], before[k])
    n_feed = np.array([2, 3, 0, 4], np.int32)
    jcache = jfam.commit_slots(jp, jnp.asarray(chunk), jnp.asarray(positions),
                               jnp.asarray(n_feed), jcache, jpend, jcfg,
                               done=jnp.asarray(done))
    cache = transformer.commit_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions),
        torch.from_numpy(n_feed), cache, pend, cfg,
        done=torch.from_numpy(done))
    n = 4 if pool == "paged" else None
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["dense"][name][:, :n].numpy(),
                                   np.asarray(jcache["dense"][name]),
                                   atol=F32_ATOL)
    if pool == "dense":
        for b in (1, 2):  # done, and nothing accepted
            assert torch.equal(cache["dense"]["k"][:, b], before["k"][:, b])


# ----------------------------------------------------- the ring page copies
def test_register_copy_and_ring_restore_copy_bit_equal_jax(win9):
    """``register_copy`` copies chosen ring blocks of prefill rows into
    registry pages, ``ring_restore_copy`` registry pages into ring pages,
    sentinel destinations dropped (the port's go to the scratch page):
    every real page equals JAX's after each."""
    jcfg, cfg, _, _ = win9
    rng = np.random.default_rng(9)
    n_pages, capacity = 10, 3
    pool, meta = paged.build_paged_pool(transformer, cfg, capacity, MAX_LEN,
                                        pages=n_pages)
    jpool, jmeta = jpaged.build_paged_pool(jax_family(jcfg), jcfg, capacity,
                                           MAX_LEN, pages=n_pages)
    assert (meta.page, meta.nblk) == (jmeta.page, jmeta.nblk) == (8, 2)
    for name in ("k", "v"):
        a = rng.standard_normal(jpool["dense"][name].shape).astype(np.float32)
        jpool["dense"][name] = jnp.asarray(a)
        pool["dense"][name][:, :n_pages] = torch.from_numpy(a)
    shape = (2, 2, 16) + tuple(pool["dense"]["k"].shape[3:])
    rows = {"dense": {name: rng.standard_normal(shape).astype(np.float32)
                      for name in ("k", "v")}}
    reg_pids = np.array([[7, n_pages], [2, 5]], np.int32)
    reg_blk = np.array([[1, 0], [0, 1]], np.int32)
    jpool = jpaged.register_copy(jpool, jnp.asarray(reg_pids),
                                 jnp.asarray(reg_blk),
                                 jax.tree.map(jnp.asarray, rows), jmeta)
    paged.register_copy(pool, torch.from_numpy(reg_pids),
                        torch.from_numpy(reg_blk),
                        {"dense": {k: torch.from_numpy(v) for k, v in
                                   rows["dense"].items()}}, meta)
    src = np.array([[7, n_pages], [2, 5]], np.int32)
    dst = np.array([[0, n_pages], [9, 3]], np.int32)
    jpool = jpaged.ring_restore_copy(jpool, jnp.asarray(src),
                                     jnp.asarray(dst), jmeta)
    paged.ring_restore_copy(pool, torch.from_numpy(src),
                            torch.from_numpy(dst), meta)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            pool["dense"][name][:, :n_pages].numpy(),
            np.asarray(jpool["dense"][name]))
    np.testing.assert_array_equal(pool["dense"]["k"][:, 0].numpy(),
                                  rows["dense"]["k"][:, 0, 8:])


# ---------------------------------------------------------------- the engine
def test_ring_pool_shape_and_exactness_inside_window(win8):
    """The windowed engine's slot pool holds a ring of 8 (O(window), not
    O(max_len)); requests that stay inside the window emit the full-cache
    model's tokens, and JAX's engine's."""
    jcfg, cfg, jp, tp = win8
    jeng, eng = _engines(jcfg, jp, cfg, tp)
    assert eng.pool["dense"]["k"].shape == jeng.pool["dense"]["k"].shape
    assert eng.pool["dense"]["k"].shape[2] == 8 < MAX_LEN
    assert eng.cache_layout == "ring"
    specs = [(3, 4), (5, 3), (2, 5), (4, 4)]
    got = eng.run(_reqs(Request, cfg.vocab_size, specs, seed0=60))
    _assert_same(got, jeng.run(_reqs(JaxRequest, cfg.vocab_size, specs,
                                     seed0=60)))
    full = cfg.replace(window=None)
    _assert_same(got, _generate_each(full, tp, _reqs(
        Request, cfg.vocab_size, specs, seed0=60)))


@pytest.mark.parametrize("pool,k", [("dense", 1), ("dense", 4),
                                    ("paged", 4)])
def test_ring_wrap_matches_jax_and_generate(win8, pool, k):
    """Sequences far past the window wrap their rings (on the paged pool a
    single-page ring): tokens equal JAX's engine's and ``generate``'s,
    counters equal JAX's."""
    jcfg, cfg, jp, tp = win8
    specs = [(3, 12), (10, 8), (6, 14), (12, 4), (5, 9)]
    jeng, eng = _engines(jcfg, jp, cfg, tp, capacity=3, k=k, pool=pool)
    got = eng.run(_reqs(Request, cfg.vocab_size, specs, seed0=80))
    _assert_same(got, jeng.run(_reqs(JaxRequest, cfg.vocab_size, specs,
                                     seed0=80)))
    _assert_same(got, _generate_each(cfg, tp, _reqs(
        Request, cfg.vocab_size, specs, seed0=80)))
    assert _counters(eng) == _counters(jeng)
    assert eng.pool_kind == pool


@pytest.mark.parametrize("spec", [False, True])
def test_window8_matches_jax_pallas_interpret(win8, spec):
    """JAX's engine on its Pallas kernels in interpret mode (the paged
    ring decode, and for a self-drafting pair the dense ring verify):
    the port's engine emits the same tokens."""
    jcfg, cfg, jp, tp = win8
    kcfg = jcfg.replace(decode_kernel="interpret")
    specs = [(4, 6), (9, 4), (3, 12)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2)
    if spec:
        jeng = JaxEngine(kcfg, jp, speculative=JaxSpeculativeConfig(
            kcfg, jp, d=2), **kw)
        eng = ContinuousBatchingEngine(cfg, tp, speculative=SpeculativeConfig(
            cfg, tp, d=2), **kw)
    else:
        jeng = JaxEngine(kcfg, jp, pool="paged", **kw)
        eng = ContinuousBatchingEngine(cfg, tp, pool="paged", **kw)
    got = eng.run(_reqs(Request, cfg.vocab_size, specs, seed0=90))
    _assert_same(got, jeng.run(_reqs(JaxRequest, cfg.vocab_size, specs,
                                     seed0=90)))
    assert (eng.n_spec_proposed, eng.n_spec_accepted) == (
        jeng.n_spec_proposed, jeng.n_spec_accepted)


def test_ring_prefix_hits_rebuild_the_ring(win9):
    """Window 9 over a ring of two pages: admissions register copies of
    the prompt's last intact page, later identical prompts HIT and
    rebuild their ring from them plus a short tail; hits, misses, page
    counts, prefills and tokens equal JAX's paged engine, fewer prefills
    than the dense pool, tokens == dense == ``generate``."""
    jcfg, cfg, jp, tp = win9
    prompt = lm_batch(cfg.vocab_size, 1, 13, seed=800)[0]
    jeng, eng = _engines(jcfg, jp, cfg, tp, pool="paged", pages=8)
    got = eng.run(_same_prompt(Request, prompt, 6))
    want = jeng.run(_same_prompt(JaxRequest, prompt, 6))
    _assert_same(got, want)
    assert eng._windowed and eng.n_prefix_hits > 0
    assert _counters(eng) == _counters(jeng)
    assert eng.pages_in_use == 0 and eng.prefix_hit_rate > 0
    dense = ContinuousBatchingEngine(cfg, tp, capacity=2, max_len=MAX_LEN,
                                     prefill_bucket=4, k=4)
    _assert_same(got, dense.run(_same_prompt(Request, prompt, 6)))
    assert eng.n_prefills < dense.n_prefills
    _assert_same(got, _generate_each(cfg, tp, _same_prompt(Request, prompt,
                                                           6)))


def test_slackless_ring_never_shares(win8):
    """Window 8 over a single-page ring of 8 keeps no intact page (the
    prompt's partial tail page clobbers it): sharing stays off, and the
    tokens stay exact."""
    jcfg, cfg, jp, tp = win8
    prompt = lm_batch(cfg.vocab_size, 1, 13, seed=810)[0]
    jeng, eng = _engines(jcfg, jp, cfg, tp, pool="paged", pages=8)
    got = eng.run(_same_prompt(Request, prompt, 4))
    assert not eng._prefix_ok and not jeng._prefix_ok
    assert eng.n_prefix_hits == 0
    _assert_same(got, jeng.run(_same_prompt(JaxRequest, prompt, 4)))
    _assert_same(got, _generate_each(cfg, tp, _same_prompt(Request, prompt,
                                                           4)))
    assert _counters(eng) == _counters(jeng)


def _nudged(jp, scale=1e-2, seed=1):
    """A draft that almost agrees with its target (JAX's ``_perturbed``
    noise scale, drawn from numpy): (JAX params, port params)."""
    rng = np.random.default_rng(seed)
    jd = jax.tree.map(lambda a: (a + scale * rng.standard_normal(
        a.shape)).astype(a.dtype), jp)
    return jd, from_jax(jd)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_ring_speculation_matches_jax(qwen_win, pool):
    """A windowed qwen3 smoke model speculates with a nudged copy of
    itself (d 3) far past its window of 8: the verify reads the ring
    layout, the commit writes ring slots of accepted positions only, the
    draft's in-place proposals are put back before its catch-up.  Tokens,
    proposals and acceptances equal JAX's engine, acceptance strictly
    inside (0, 1), tokens == ``generate``; no prefix sharing."""
    jcfg, cfg, jp, tp = qwen_win
    jd, td = _nudged(jp)
    specs = [(4, 18), (9, 14), (6, 16)]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2, pool=pool)
    jeng = JaxEngine(jcfg, jp, speculative=JaxSpeculativeConfig(
        jcfg, jd, d=3), **kw)
    eng = ContinuousBatchingEngine(cfg, tp, speculative=SpeculativeConfig(
        cfg, td, d=3), **kw)
    got = eng.run(_reqs(Request, cfg.vocab_size, specs, seed0=80))
    _assert_same(got, jeng.run(_reqs(JaxRequest, cfg.vocab_size, specs,
                                     seed0=80)))
    _assert_same(got, _generate_each(cfg, tp, _reqs(
        Request, cfg.vocab_size, specs, seed0=80)))
    assert _counters(eng) == _counters(jeng)
    assert 0.0 < eng.acceptance_rate < 1.0
    assert not eng._prefix_ok and eng.n_prefix_hits == 0
    assert eng.pool_d["dense"]["k"].shape[2] == 8


def test_sampled_windowed_prefix_hit_matches_jax(win9):
    """Sampled serving of the window-9 model with ring prefix hits: a hit
    replays its (seed, uid) chain as the skipped prefill would, so the
    paged engine's tokens equal the dense engine's, a sequential replay's
    and JAX's paged engine's (near ties aside); hits and prefills equal
    JAX's."""
    jcfg, cfg, jp, tp = win9
    sp = SamplingParams(temperature=0.9, top_k=12, seed=11)
    jsp = JaxSamplingParams(temperature=0.9, top_k=12, seed=11)
    prompt = lm_batch(cfg.vocab_size, 1, 19, seed=820)[0]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
    eng = ContinuousBatchingEngine(cfg, tp, pool="paged", pages=8,
                                   sampling=sp, **kw)
    got = eng.run(_same_prompt(Request, prompt, 6))
    assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
    jeng = JaxEngine(jcfg, jp, pool="paged", pages=8, sampling=jsp, **kw)
    want = jeng.run(_same_prompt(JaxRequest, prompt, 6))
    assert (eng.n_prefix_hits, eng.n_prefills) == (jeng.n_prefix_hits,
                                                   jeng.n_prefills)
    dense = ContinuousBatchingEngine(cfg, tp, sampling=sp, **kw)
    got_d = dense.run(_same_prompt(Request, prompt, 6))
    assert len({tuple(v.tolist()) for v in got.values()}) > 1
    for r in _same_prompt(Request, prompt, 6):
        drawn, gaps = sampled_replay(cfg, tp, r.prompt, r.uid, sp,
                                     got[r.uid], MAX_LEN)
        check_sampled("paged vs replay", r.uid, got[r.uid], drawn, gaps)
        check_sampled("paged vs JAX", r.uid, got[r.uid], want[r.uid], gaps)
        check_sampled("paged vs dense", r.uid, got[r.uid], got_d[r.uid],
                      gaps)


# ------------------------------------------------------ growth and training
def _close_trees(got, want, atol):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, want)))
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=0,
                                   err_msg=str(path))


def test_windowed_growth_and_train_step_match_jax():
    """gpt-micro -> gpt-micro-big with a window of 6 on both: Mango grows
    the converted weights as JAX does, and one train step of the grown
    windowed model gives JAX's loss, gradient norm and parameters."""
    js = jax_get_config("gpt-micro").replace(window=6)
    jt = jax_get_config("gpt-micro-big").replace(window=6)
    ts, tt = port_config(js), port_config(jt)
    src = jax_params(js, seed=1)
    jgop, jop = jgrow.build("mango", js, jt, rank=1)
    jbig = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build("mango", ts, tt, rank=1, device="cpu")
    big = grow.grow_params(gop, from_jax(jax.tree.map(np.asarray, jop)),
                           from_jax(src))
    _close_trees(big, jbig, F32_ATOL)
    jopt, opt = JaxOptimizerConfig(lr=1e-3), OptimizerConfig(lr=1e-3)
    jinit, _ = jax_make_optimizer(jopt)
    init, _ = make_optimizer(opt)
    toks = lm_batch(tt.vocab_size, 4, 24, seed=6)
    jnew, _, jm = jax.jit(jax_make_train_step(jt, jopt))(
        jbig, jinit(jbig), {"tokens": jnp.asarray(toks)}, jnp.int32(1))
    new, _, m = make_train_step(tt, opt)(big, init(big), {
        "tokens": torch.from_numpy(toks)}, 1)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    _close_trees(new, jnew, 1e-4)
