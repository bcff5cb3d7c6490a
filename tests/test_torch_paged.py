"""The port's paged slot pool against the JAX package (CPU).

``serve/paged.py`` (allocator, geometry, scatters, digests), the paged
gather and the two paged kernels' plain versions (against JAX's oracle and
its Pallas kernels in interpret mode), the model's paged slot decode and
paged verify/commit, and the paged engine -- plain, under page pressure
and speculative -- against JAX's paged engine: tokens and the prefix,
page and host-sync counters exactly equal.  These use gpt-micro(-big)
and a tiny GQA decoder; the RoPE configs (the JAX paged tests' subject,
qwen-smoke) page in ``test_torch_rope.py``.  The CUDA kernels are held
against the plain versions in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, both_params, port_config, tiny_gqa
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import get_family as jax_family
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import paged as jpaged
from repro_torch.convert import from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    paged_chunk_verify_attention as cuda_paged_chunk,
)
from repro_torch.kernels.decode_attention import (
    paged_decode_splits,
)
from repro_torch.kernels.decode_attention import (
    paged_slot_decode_attention as cuda_paged_slot,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.models import attention, transformer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SpeculativeConfig,
)
from repro_torch.serve import paged

MAX_LEN = 32  # pad_cache_len(32) = 32: page 8, nblk 4


@pytest.fixture(scope="module")
def gpt():
    jcfg = jax_get_config("gpt-micro-big")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


@pytest.fixture(scope="module")
def gqa():
    jcfg = tiny_gqa()
    jp, tp = both_params(jcfg, randomize=True)
    return jcfg, port_config(jcfg), jp, tp


def _with_scratch(a):
    """A JAX arena (L, n_pages, page, ...) as the port's, whose scratch
    page (index n_pages) holds garbage that nothing may read."""
    t = torch.from_numpy(np.array(a))
    return torch.cat([t, torch.full_like(t[:, :1], 7.5)], 1)


# ------------------------------------------------------------- allocator
def _allocator_state(a):
    return (list(a.free), a.refcount.tolist(), dict(a.registry),
            dict(a.page_key), list(a.lru), a.highwater, a.pages_in_use(),
            a.available())


def test_page_allocator_follows_jax_call_for_call():
    """The same call sequence -- allocs in two namespaces, registration,
    lookups, increfs, releases to zero, LRU reclaim under a dry free list,
    an all-or-nothing refusal, a registry flush -- gives the same page
    ids, refcounts, registry and LRU as JAX's allocator."""
    meta_j = jpaged.PoolMeta(page=4, nblk=3, n_pages=7)
    meta_t = paged.PoolMeta(page=4, nblk=3, n_pages=7)
    ja, ta = jpaged.PageAllocator(meta_j, 2), paged.PageAllocator(meta_t, 2)
    toks = lm_batch(97, 1, 13, seed=3)[0]
    dj, dt = jpaged.prefix_digests(toks, 4), paged.prefix_digests(toks, 4)
    assert dj == dt and len(dt) == 3
    calls = [
        ("alloc", (3,), {"ns": (0, 1)}), ("alloc", (2,), {}),
        ("register", (dt[:2], None), {}), ("lookup", (dt[:2],), {}),
        ("lookup", (dt,), {}), ("release", (None,), {"ns": 1}),
        ("release", (None,), {"ns": 0}), ("incref", (None,), {}),
        ("alloc", (5,), {}), ("alloc", (3,), {"ns": (0, 1)}),
        ("release", (None,), {"ns": 0}), ("alloc", (4,), {}),
        ("flush_registry", (), {}), ("alloc", (1,), {}),
    ]
    held = {}
    for i, (name, args, kw) in enumerate(calls):
        outs = []
        for a in (ja, ta):
            # ``None`` stands for the pages the first alloc returned
            args_i = tuple(held.get(id(a), []) if x is None else x
                           for x in args)
            out = getattr(a, name)(*args_i, **kw)
            if name == "alloc" and i == 0:
                held[id(a)] = out
            outs.append(out)
        assert outs[0] == outs[1], (i, name, outs)
        assert _allocator_state(ja) == _allocator_state(ta), (i, name)
    assert ta.alloc(99) is None  # all-or-nothing: nothing was taken
    assert _allocator_state(ta) == _allocator_state(ja)


# -------------------------------------------------------------- geometry
@pytest.mark.parametrize("name,capacity,max_len,pages", [
    ("gpt", 3, MAX_LEN, None), ("gpt", 2, 300, 5), ("gqa", 4, 20, 11)])
def test_pool_meta_and_build_paged_pool_match_jax(gpt, gqa, name, capacity,
                                                  max_len, pages):
    """The geometry equals JAX's, and every arena is JAX's shape plus the
    one scratch page (zeroed, tables at the sentinel)."""
    jcfg, tcfg = (gpt if name == "gpt" else gqa)[:2]
    jpool, jmeta = jpaged.build_paged_pool(jax_family(jcfg), jcfg, capacity,
                                           max_len, pages=pages)
    tpool, tmeta = paged.build_paged_pool(transformer, tcfg, capacity,
                                          max_len, pages=pages)
    assert (tmeta.page, tmeta.nblk, tmeta.n_pages, tmeta.sentinel) == (
        jmeta.page, jmeta.nblk, jmeta.n_pages, jmeta.sentinel)
    assert [(g.path, g.kind, g.leaves, g.page, g.nblk) for g in
            tmeta.groups] == [(g.path, g.kind, g.leaves, g.page, g.nblk)
                              for g in jmeta.groups]
    meta_shapes = transformer.init_cache(tcfg, capacity, max_len,
                                         device="meta")
    assert paged.pool_meta(tcfg, meta_shapes, pages) == tmeta
    for lk, jleaf in jpool["dense"].items():
        tleaf = tpool["dense"][lk]
        want = list(jleaf.shape)
        if lk != "bt":
            want[1] += 1  # the scratch page
        assert list(tleaf.shape) == want, lk
        assert str(tleaf.dtype).split(".")[1] == str(jleaf.dtype)
        assert (tleaf.numpy() == (np.asarray(jleaf)[0, 0, 0] if lk == "bt"
                                  else 0)).all()
    for P, n in ((1, 1), (9, 7), (max_len - 3, 3)):
        assert paged.pages_needed(P, n, tmeta) == jpaged.pages_needed(
            P, n, jmeta)


def _random_paged(jcfg, tcfg, capacity, pages, seed):
    """The same random paged pool in both frameworks: arenas of random
    values, tables of a seeded page permutation with sentinel tails."""
    jpool, meta_j = jpaged.build_paged_pool(jax_family(jcfg), jcfg,
                                            capacity, MAX_LEN, pages=pages)
    _, meta_t = paged.build_paged_pool(transformer, tcfg, capacity,
                                       MAX_LEN, pages=pages)
    rng = np.random.default_rng(seed)
    arenas = {n: rng.standard_normal(jpool["dense"][n].shape).astype(
        np.float32) for n in ("k", "v")}
    perm = rng.permutation(pages)
    bt = np.full((capacity, meta_j.nblk), pages, np.int32)
    for b in range(capacity):
        used = min(b + 1, meta_j.nblk)
        bt[b, :used] = perm[b * 2:b * 2 + used] % pages
    bt_l = np.broadcast_to(bt, jpool["dense"]["bt"].shape).copy()
    jpool = {"dense": {**{n: jnp.asarray(a) for n, a in arenas.items()},
                       "bt": jnp.asarray(bt_l)}}
    tpool = {"dense": {**{n: _with_scratch(a) for n, a in arenas.items()},
                       "bt": torch.from_numpy(bt_l.copy())}}
    return jpool, tpool, meta_j, meta_t, rng


def _assert_pool_equal(tpool, jpool, n_pages):
    for name, jleaf in jpool["dense"].items():
        got = tpool["dense"][name]
        if name != "bt":
            got = got[:, :n_pages]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jleaf),
                                      err_msg=name)


def test_scatters_bit_equal_jax(gqa):
    """``admit_scatter``, ``set_block_tables`` and ``evict_clear`` leave
    the real pages and the tables bit-equal to JAX's; sentinel blocks of
    an admission land in the scratch page only."""
    jcfg, tcfg = gqa[:2]
    cap, n_pages = 4, 10
    jpool, tpool, mj, mt, rng = _random_paged(jcfg, tcfg, cap, n_pages, 1)
    L, S = tcfg.n_layers, MAX_LEN
    rows = {n: rng.standard_normal((L, 2, S, tcfg.n_kv_heads,
                                    tcfg.head_dim)).astype(np.float32)
            for n in ("k", "v")}
    slots = np.array([3, 1])
    bt_rows = np.array([[8, 2, n_pages, n_pages], [5, 0, 9, 4]], np.int32)
    jpool = jpaged.admit_scatter(jpool, {"dense": {
        n: jnp.asarray(a) for n, a in rows.items()}}, jnp.asarray(slots),
        jnp.asarray(bt_rows), mj)
    paged.admit_scatter(tpool, {"dense": {
        n: torch.from_numpy(a) for n, a in rows.items()}},
        torch.from_numpy(slots), torch.from_numpy(bt_rows), mt)
    _assert_pool_equal(tpool, jpool, n_pages)
    hit_rows = np.array([[5, 0, 7, n_pages]], np.int32)
    jpool = jpaged.set_block_tables(jpool, jnp.asarray([2]),
                                    jnp.asarray(hit_rows), mj)
    paged.set_block_tables(tpool, torch.tensor([2]),
                           torch.from_numpy(hit_rows), mt)
    _assert_pool_equal(tpool, jpool, n_pages)
    zero = np.array([8, 2, n_pages, n_pages], np.int32)
    jpool = jpaged.evict_clear(jpool, jnp.asarray(slots), jnp.asarray(zero),
                               mj)
    paged.evict_clear(tpool, torch.from_numpy(slots), torch.from_numpy(zero),
                      mt)
    _assert_pool_equal(tpool, jpool, n_pages)
    assert (tpool["dense"]["bt"][:, slots] == n_pages).all()
    assert (tpool["dense"]["k"][:, 8] == 0).all()
    assert (tpool["dense"]["k"][:, 5] != 0).any()  # still held: kept


def test_paged_gather_bit_equal_jax():
    rng = np.random.default_rng(2)
    arena = rng.standard_normal((6, 4, 2, 3)).astype(np.float32)
    bt = np.array([[3, 0, 6], [6, 6, 6], [5, 1, 2]], np.int32)
    want = np.asarray(jattn.paged_gather(jnp.asarray(arena),
                                         jnp.asarray(bt)))
    got = attention.paged_gather(torch.from_numpy(arena),
                                 torch.from_numpy(bt))
    assert got.shape == (3, 12, 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_register_copy_and_ring_restore_raise_for_the_ring_slice(gqa):
    _, tcfg = gqa[:2]
    with pytest.raises(NotImplementedError, match="ring slice"):
        paged.register_copy(None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="ring slice"):
        paged.ring_restore_copy(None, None, None, None)
    windowed = port_config(tiny_gqa(window=8))
    with pytest.raises(NotImplementedError, match="ring slice"):
        paged.build_paged_pool(transformer, windowed, 2, MAX_LEN)
    with pytest.raises(NotImplementedError, match="ring slice"):
        ContinuousBatchingEngine(windowed, {}, max_len=MAX_LEN, pool="paged")
    q = torch.zeros(2, 3, 4, 64)
    with pytest.raises(NotImplementedError, match="ring slice"):
        cuda_paged_chunk(q, None, None, None, None, None, None, ring=True)


# ----------------------------------------------------- the plain kernels
def _arena_inputs(seed, B, H, KV, hd, n_pages, page, nblk, dtype):
    """Random q and arenas, and non-contiguous tables (a seeded page
    permutation) with sentinel entries."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    perm = rng.permutation(n_pages)
    bt = np.full((B, nblk), n_pages, np.int32)
    for b in range(B):
        take = perm[(b * nblk) % n_pages:][:nblk - (b % 2)]
        bt[b, :len(take)] = take
    return rng, rnd, bt, rnd(n_pages, page, KV, hd), rnd(n_pages, page, KV,
                                                           hd)


def _to_torch(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.bfloat16() if dtype == "bfloat16" else t


@pytest.mark.parametrize("G,dtype", [(1, "float32"), (2, "float32"),
                                     (4, "float32"), (2, "bfloat16")])
def test_paged_slot_plain_matches_jax_ref_and_pallas(G, dtype):
    """Ragged kv_len (0, one inside a sentinel block, the full table, past
    it), GQA, done rows: f32 within 1e-5, bf16 within one output
    rounding."""
    B, KV, hd, n_pages, page, nblk = 6, 2, 16, 11, 8, 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng, rnd, bt, k, v = _arena_inputs(G, B, G * KV, KV, hd, n_pages, page,
                                       nblk, jdt)
    q = rnd(B, G * KV, hd)
    kv_len = np.array([0, 31, 32, 9, 40, 17], np.int32)
    done = np.array([False, False, False, False, False, True])
    jin = [jnp.asarray(a) for a in (q, k, v, bt)]
    want = [jops.paged_slot_decode_attention(
        *jin, jnp.asarray(kv_len), mode=m, done=jnp.asarray(done))
        for m in ("reference", "interpret")]
    got = ops.paged_slot_decode_attention(
        *(_to_torch(a, dtype) for a in (q, k, v)), torch.from_numpy(bt),
        torch.from_numpy(kv_len), done=torch.from_numpy(done))
    assert got.shape == (B, G * KV, hd)
    assert (got[0] == 0).all() and (got[5] == 0).all()
    tol = (dict(atol=5e-3, rtol=1e-2) if dtype == "bfloat16"
           else dict(atol=1e-5, rtol=0))
    for w in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("G,window,dtype", [
    (1, None, "float32"), (2, None, "float32"), (4, 8, "float32"),
    (2, None, "bfloat16")])
def test_paged_chunk_plain_matches_jax_ref_and_pallas(G, window, dtype):
    """Offsets -1 (done), 0, mid, inside a sentinel block, the full
    table and past it; chunks attend [cache ‖ chunk] through the table."""
    B, S, KV, hd, n_pages, page, nblk = 6, 3, 2, 16, 11, 8, 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng, rnd, bt, ck, cv = _arena_inputs(10 + G, B, G * KV, KV, hd, n_pages,
                                         page, nblk, jdt)
    q, k, v = rnd(B, S, G * KV, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    offsets = np.array([-1, 0, 13, 29, 32, 35], np.int32)
    done = np.array([False, True, False, False, False, False])
    jin = [jnp.asarray(a) for a in (q, ck, cv, bt, k, v)]
    want = [jops.paged_chunk_verify_attention(
        *jin, jnp.asarray(offsets), ring=False, window=window, mode=m,
        done=jnp.asarray(done)) for m in ("reference", "interpret")]
    tin = [_to_torch(a, dtype) for a in (q, ck, cv)]
    got = ops.paged_chunk_verify_attention(
        *tin, torch.from_numpy(bt), *(_to_torch(a, dtype) for a in (k, v)),
        torch.from_numpy(offsets), ring=False, window=window,
        done=torch.from_numpy(done))
    assert (got[0] == 0).all() and (got[1] == 0).all()
    tol = (dict(atol=5e-3, rtol=1e-2) if dtype == "bfloat16"
           else dict(atol=1e-5, rtol=0))
    for w in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("S,G,window", [(17, 1, None), (17, 4, 8),
                                        (33, 2, None), (33, 1, 8)])
def test_paged_chunk_plain_matches_pallas_past_16_keys(S, G, window):
    """Chunks of 17 and 33 keys (speculation depth 16 and 32) through the
    table: the plain version against the JAX oracle and the Pallas kernel;
    f32 within 1e-5."""
    B, KV, hd, n_pages, page, nblk = 6, 2, 16, 11, 8, 4
    rng, rnd, bt, ck, cv = _arena_inputs(S + G, B, G * KV, KV, hd, n_pages,
                                         page, nblk, np.float32)
    q, k, v = rnd(B, S, G * KV, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    offsets = np.array([-1, 0, 13, 29, 32, 35], np.int32)
    jin = [jnp.asarray(a) for a in (q, ck, cv, bt, k, v)]
    want = [jops.paged_chunk_verify_attention(
        *jin, jnp.asarray(offsets), ring=False, window=window, mode=m)
        for m in ("reference", "interpret")]
    got = ops.paged_chunk_verify_attention(
        *(torch.from_numpy(a) for a in (q, ck, cv, bt, k, v)),
        torch.from_numpy(offsets), ring=False, window=window)
    assert got.shape == (B, S, G * KV, hd) and (got[0] == 0).all()
    for w in want:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_cpu_tensors_take_the_plain_versions_and_wrappers_refuse_them():
    rng, rnd, bt, k, v = _arena_inputs(5, 2, 4, 2, 64, 5, 8, 3, np.float32)
    q = torch.from_numpy(rnd(2, 4, 64))
    k, v, bt = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bt)
    kvl = torch.tensor([5, 20], dtype=torch.int32)
    n0 = (cuda_paged_slot.launches, cuda_paged_chunk.launches)
    ops.paged_slot_decode_attention(q, k, v, bt, kvl)
    ops.paged_chunk_verify_attention(q[:, None], k, v, bt, k[:2, :1],
                                     v[:2, :1], kvl, ring=False)
    assert (cuda_paged_slot.launches, cuda_paged_chunk.launches) == n0
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_paged_slot(q, k, v, bt, kvl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_paged_chunk(q[:, None], k, v, bt, k[:2, :1], v[:2, :1], kvl,
                         ring=False)


@pytest.mark.parametrize("B,KV,span,per_sm,want", [
    (8, 12, 1024, 3, (256, 4)),   # gpt-base f32: 3 blocks an SM, one wave
    (8, 12, 1024, 5, (192, 6)),   # gpt-base bf16: 5 an SM, capped at 4.5
    (8, 1, 2048, 1, (128, 16)),   # recurrentgemma-2b: a 16-block cluster
    (8, 8, 1024, 3, (192, 6)),    # qwen3-0.6b's paged pool (hd 128, G 2)
    (3, 2, 37, 4, (32, 2)),       # ragged: pieces of one tile
    (64, 32, 4096, 3, (4096, 1)),  # more bands than the card holds
])
def test_paged_decode_splits_pin_the_cut_of_each_band(B, KV, span, per_sm,
                                                      want):
    """The paged slot and ring kernels' split (132 SMs, an H100 SXM): each
    band in pieces of a multiple of 32 positions, at most 16 (one
    thread-block cluster), covering the band with no empty last piece."""
    chunk, nsplit = paged_decode_splits(B, KV, span, 132, per_sm)
    assert (chunk, nsplit) == want
    assert chunk % 32 == 0 and 1 <= nsplit <= 16
    assert chunk * (nsplit - 1) < span <= chunk * nsplit


# ------------------------------------------------------------ the model
def _prefilled_rows(cfg, params, B, P, seed):
    toks = lm_batch(cfg.vocab_size, B, P, seed=seed)
    rows = transformer.init_cache(cfg, B, MAX_LEN)
    transformer.prefill_full(params, {"tokens": torch.from_numpy(toks)}, cfg,
                             rows)
    return rows


def _paged_from_rows(cfg, rows, capacity, n_pages, bt_rows):
    pool, meta = paged.build_paged_pool(transformer, cfg, capacity, MAX_LEN,
                                        pages=n_pages)
    n = bt_rows.shape[0]
    paged.admit_scatter(pool, {"dense": {k: v[:, :n] for k, v in
                                         rows["dense"].items()}},
                        torch.arange(n), torch.from_numpy(bt_rows), meta)
    return pool, meta


def test_decode_step_slots_paged_matches_dense(gqa):
    """The same rows on a dense and a paged pool (scattered pages): a few
    decode steps give the same logits (2e-5), with a done row."""
    _, cfg, _, params = gqa
    B = 3
    rows = _prefilled_rows(cfg, params, B, 9, seed=4)
    dense = {"dense": {k: v.clone() for k, v in rows["dense"].items()}}
    bt_rows = np.array([[7, 2, 11, 0], [5, 9, 1, 3], [4, 8, 6, 10]],
                       np.int32)
    pool, _ = _paged_from_rows(cfg, rows, B, 12, bt_rows)
    rng = np.random.default_rng(5)
    positions = torch.tensor([9, 9, 9], dtype=torch.int32)
    done = torch.tensor([False, True, False])
    for _ in range(4):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(
            np.int32))
        want, dense = transformer.decode_step_slots(params, toks, positions,
                                                    dense, cfg, done=done)
        got, pool = transformer.decode_step_slots(params, toks, positions,
                                                  pool, cfg, done=done)
        live = ~done
        np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                                   atol=F32_ATOL)
        positions = positions + torch.where(done, 0, 1).int()


def test_verify_and_commit_on_paged_pools_match_jax(gpt):
    """``verify_step_slots`` over a paged pool equals JAX's (logits 2e-5)
    and leaves the arenas alone; ``commit_slots`` writes the accepted
    prefixes where JAX's does, and rows committing nothing keep every
    page bit-for-bit."""
    jcfg, tcfg, jp, tp = gpt
    B, S, P, n_pages = 4, 4, 10, 14
    toks = lm_batch(jcfg.vocab_size, B, P, seed=6)
    jfam = jax_family(jcfg)
    _, jrows = jfam.prefill_full(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jfam.init_cache(jcfg, B, MAX_LEN))
    bt_rows = np.array([[3, 12, 0, 14], [5, 1, 9, 7], [14, 14, 14, 14],
                        [2, 8, 14, 14]], np.int32)
    jpool, jmeta = jpaged.build_paged_pool(jfam, jcfg, B, MAX_LEN,
                                           pages=n_pages)
    jpool = jpaged.admit_scatter(jpool, jrows, jnp.arange(B),
                                 jnp.asarray(bt_rows), jmeta)
    tpool, _ = _paged_from_rows(tcfg, {"dense": {
        k: torch.from_numpy(np.array(v)) for k, v in
        jrows["dense"].items()}}, B, n_pages, bt_rows)
    rng = np.random.default_rng(7)
    chunk = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.array([P, 3, 0, P], np.int32)
    n_feed = np.array([3, 0, 0, 4], np.int32)
    done = np.array([False, False, True, False])
    jlog, jpend = jfam.verify_step_slots(jp, jnp.asarray(chunk),
                                         jnp.asarray(positions), jpool, jcfg,
                                         done=jnp.asarray(done))
    before = {n: t.clone() for n, t in tpool["dense"].items()}
    tlog, tpend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions), tpool,
        tcfg, done=torch.from_numpy(done))
    live = ~done
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               atol=F32_ATOL)
    for n, t in tpool["dense"].items():
        assert torch.equal(t, before[n]), n
    want = jfam.commit_slots(jp, jnp.asarray(chunk), jnp.asarray(positions),
                             jnp.asarray(n_feed), jpool, jpend, jcfg,
                             done=jnp.asarray(done))
    got = transformer.commit_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions),
        torch.from_numpy(n_feed), tpool, tpend, tcfg,
        done=torch.from_numpy(done))
    assert got is tpool
    for n in ("k", "v"):
        np.testing.assert_allclose(got["dense"][n][:, :n_pages].numpy(),
                                   np.asarray(want["dense"][n]),
                                   atol=F32_ATOL, err_msg=n)
        # pages of rows 1 and 2 (nothing committed) and the free pages
        untouched = [p for p in range(n_pages) if p not in (3, 12, 2, 8)]
        assert torch.equal(got["dense"][n][:, untouched],
                           before[n][:, untouched]), n
    np.testing.assert_array_equal(got["dense"]["bt"].numpy(),
                                  np.asarray(want["dense"]["bt"]))


def test_dropped_writes_leave_every_other_page_unchanged(gqa):
    """Writes that must be dropped -- a done row with an all-sentinel
    table, a position past the row's allocated pages, a position at
    nblk * page, uncommitted chunk entries -- land in the scratch page:
    every real page except the one really written stays bit-for-bit."""
    _, cfg, _, params = gqa
    pool, meta = paged.build_paged_pool(transformer, cfg, 4, MAX_LEN,
                                        pages=9)
    gen = torch.Generator().manual_seed(3)
    for n in ("k", "v"):
        pool["dense"][n].copy_(torch.randn(pool["dense"][n].shape,
                                           generator=gen))
    bt = torch.tensor([[4, 0, 9, 9], [1, 2, 3, 5], [9, 9, 9, 9],
                       [6, 9, 9, 9]], dtype=torch.int32)
    pool["dense"]["bt"].copy_(bt.expand_as(pool["dense"]["bt"]))
    before = {n: t.clone() for n, t in pool["dense"].items()}
    # row 0 writes page 4 offset 5; row 1 at 32 = nblk * page, row 2
    # done, row 3 at 12 (block 1 holds no page): all three dropped
    positions = torch.tensor([5, 32, 3, 12], dtype=torch.int32)
    done = torch.tensor([False, False, True, False])
    logits, pool = transformer.decode_step_slots(
        params, torch.tensor([1, 2, 3, 4], dtype=torch.int32), positions,
        pool, cfg, done=done)
    assert torch.isfinite(logits).all()
    for n in ("k", "v"):
        a, b = pool["dense"][n], before[n]
        assert not torch.equal(a[:, 4, 5], b[:, 4, 5])
        a4, b4 = a[:, 4].clone(), b[:, 4].clone()
        a4[:, 5] = b4[:, 5] = 0
        assert torch.equal(a4, b4)
        others = [p for p in range(9) if p != 4]
        assert torch.equal(a[:, others], b[:, others]), n
    # a commit: row 0 commits 2 entries at 6, 7 (page 4), rows 1-3 none
    before = {n: t.clone() for n, t in pool["dense"].items()}
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pend = {"dense": {n: torch.randn(L, 4, 3, KV, hd, generator=gen)
                      for n in ("k", "v")}}
    transformer.commit_slots(params, None, torch.tensor(
        [6, 30, 0, 11], dtype=torch.int32), torch.tensor([2, 3, 3, 3]),
        pool, pend, cfg, done=torch.tensor([False, False, True, True]))
    for n in ("k", "v"):
        a, b = pool["dense"][n], before[n]
        assert torch.equal(a[:, 4, 6:8], pend["dense"][n][:, 0, :2])
        # row 1 commits 30, 31 on page 5 and drops 32 (past the table)
        assert torch.equal(a[:, 5, 6:8], pend["dense"][n][:, 1, :2])
        keep = [p for p in range(9) if p not in (4, 5)]
        assert torch.equal(a[:, keep], b[:, keep]), n
        assert torch.equal(a[:, 4, :6], b[:, 4, :6])
        assert torch.equal(a[:, 5, :6], b[:, 5, :6])


# ------------------------------------------------------------ the engine
def _prefix_mix(vocab, n_shared=5, seed=200):
    """Prompts that open with the same 18 tokens (two full pages of 8),
    then 2..6 tokens of their own, and three distinct prompts."""
    prefix = lm_batch(vocab, 1, 18, seed=seed)[0]
    specs = []
    for i in range(n_shared):
        tail = lm_batch(vocab, 1, 2 + i, seed=seed + 10 + i)[0]
        specs.append((np.concatenate([prefix, tail]), 5 + i % 3))
    for i, (p, g) in enumerate([(7, 6), (3, 9), (12, 4)]):
        specs.append((lm_batch(vocab, 1, p, seed=seed + 50 + i)[0], g))
    return specs


def _reqs(make, specs, uid0=0):
    return [make(uid=uid0 + i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(specs)]


def _generate_each(cfg, params, reqs):
    return {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens,
                            max_len=MAX_LEN)[0].numpy() for r in reqs}


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")


COUNTERS = ("n_prefix_hits", "n_prefix_misses", "n_prefix_stalls",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens")


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


def _engines(jcfg, jp, tcfg, tp, **kw):
    kw = dict(dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4,
                   pool="paged"), **kw)
    return JaxEngine(jcfg, jp, **kw), ContinuousBatchingEngine(tcfg, tp, **kw)


@pytest.mark.parametrize("k", [1, 4])
def test_paged_engine_matches_jax_paged_engine(gpt, k):
    """A shared-prefix mix at capacity 2: later waves hit the registered
    prefix pages.  Tokens equal JAX's paged engine and ``generate``; the
    prefix, page, prefill, dispatch and host-sync counters equal JAX's."""
    jcfg, tcfg, jp, tp = gpt
    specs = _prefix_mix(jcfg.vocab_size)
    jeng, eng = _engines(jcfg, jp, tcfg, tp, k=k)
    want = jeng.run(_reqs(JaxRequest, specs))
    got = eng.run(_reqs(Request, specs))
    _assert_same(got, want)
    _assert_same(got, _generate_each(tcfg, tp, _reqs(Request, specs)))
    assert _counters(eng) == _counters(jeng)
    assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
    assert eng.prefix_hit_rate == pytest.approx(jeng.prefix_hit_rate)
    assert eng.pool_kind == "paged" and eng.pages_budget == 2 * 4


def _stepped(eng, reqs):
    """Drive ``step()`` to the end; the sorted active uids after each."""
    for r in reqs:
        eng.submit(r)
    trace = []
    while eng.waiting or eng.active:
        eng.step()
        trace.append(sorted(s.req.uid for s in eng.active.values()))
    return trace


def test_backpressure_admits_in_the_same_order_as_jax(gqa):
    """Fewer pages than the trace wants at once: admission waits for
    evictions (all-or-nothing) instead of admitting partially, in the
    same order as JAX's engine, with the same stalls and high-water."""
    jcfg, tcfg, jp, tp = gqa
    specs = [(p, g) for p, g in _prefix_mix(jcfg.vocab_size, seed=120)]
    jeng, eng = _engines(jcfg, jp, tcfg, tp, capacity=4, pages=6, k=2)
    jtrace = _stepped(jeng, _reqs(JaxRequest, specs))
    ttrace = _stepped(eng, _reqs(Request, specs))
    assert ttrace == jtrace
    assert _counters(eng) == _counters(jeng)
    _assert_same(eng.finished, jeng.finished)
    assert eng.pages_highwater <= 6 < 4 * 4
    assert any(len(t) < min(4, len(specs)) for t in ttrace[:2])


def test_prefix_hit_under_pressure_pins_resident_pages(gqa, monkeypatch):
    """JAX's regression scenario: a hit must pin (incref) the resident
    pages BEFORE allocating its tail, or a dry free list reclaims the very
    pages just looked up as the slot's private tail.  The hit stalls
    instead (``n_prefix_stalls``, not a miss), no admission books a page
    twice, and tokens equal ``generate`` and JAX's engine."""
    jcfg, tcfg, jp, tp = gqa
    V = jcfg.vocab_size
    prefix = lm_batch(V, 1, 17, seed=600)[0]
    specs = [(lm_batch(V, 1, 9, seed=601)[0], 15),  # 3 pages, long-lived
             (prefix, 1),  # 3 pages, registers 2
             (np.concatenate([prefix[:16], lm_batch(V, 1, 1, seed=602)[0]]),
              14)]  # hit: 2 resident + 2 tail pages
    orig = ContinuousBatchingEngine._alloc_request
    double_booked = []

    def checked(self, req):
        info = orig(self, req)
        if info is not None and len(set(info["pids"])) != len(info["pids"]):
            double_booked.append((req.uid, info["pids"]))
        return info

    monkeypatch.setattr(ContinuousBatchingEngine, "_alloc_request", checked)
    jeng, eng = _engines(jcfg, jp, tcfg, tp, capacity=2, pages=6, k=4)
    got = eng.run(_reqs(Request, specs))
    want = jeng.run(_reqs(JaxRequest, specs))
    assert not double_booked
    assert eng.n_prefix_hits == 1 and eng.n_prefix_stalls >= 1
    assert eng.n_prefix_misses == 2 and eng.pages_highwater <= 6
    _assert_same(got, want)
    _assert_same(got, _generate_each(tcfg, tp, _reqs(Request, specs)))
    assert _counters(eng) == _counters(jeng)


def test_oversize_request_rejected_with_the_page_reason(gqa):
    """A request no eviction wave could make room for is rejected at
    submit (recorded, not raised), as JAX's engine does; the rest serve."""
    jcfg, tcfg, jp, tp = gqa
    specs = [(lm_batch(jcfg.vocab_size, 1, 9, seed=700)[0], 8),  # 3 pages
             (lm_batch(jcfg.vocab_size, 1, 4, seed=701)[0], 3)]  # 1 page
    jeng, eng = _engines(jcfg, jp, tcfg, tp, pages=2, k=4)
    got = eng.run(_reqs(Request, specs))
    jeng.run(_reqs(JaxRequest, specs))
    assert "needs 3 pages but the arena holds only 2" in eng.rejected[0]
    assert eng.rejected[0] == jeng.rejected[0] and 0 not in got
    _assert_same(got, _generate_each(tcfg, tp, _reqs(Request, specs[1:],
                                                     uid0=1)))


def test_paged_speculation_matches_jax():
    """JAX's paged speculative setup: gpt-micro drafts for gpt-micro-big
    (independent inits), both pools on ONE arena.  Tokens, proposals and
    acceptances equal JAX's paged speculative engine and ``generate``;
    every page is released at the end."""
    jcfg_t, jcfg_d = jax_get_config("gpt-micro-big"), jax_get_config(
        "gpt-micro")
    jp_t = jax.tree.map(np.asarray, jax_family(jcfg_t).init(
        jax.random.PRNGKey(0), jcfg_t))
    jp_d = jax.tree.map(np.asarray, jax_family(jcfg_d).init(
        jax.random.PRNGKey(1), jcfg_d))
    cfg_t, cfg_d = port_config(jcfg_t), port_config(jcfg_d)
    p_t, p_d = from_jax(jp_t), from_jax(jp_d)
    specs = [(lm_batch(jcfg_t.vocab_size, 1, p, seed=70 + i)[0], g)
             for i, (p, g) in enumerate([(4, 6), (9, 3), (6, 5), (11, 7)])]
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2,
              pool="paged", pages=7)
    jeng = JaxEngine(jcfg_t, jp_t, speculative=JaxSpeculativeConfig(
        jcfg_d, jp_d, d=2), **kw)
    eng = ContinuousBatchingEngine(cfg_t, p_t, speculative=SpeculativeConfig(
        cfg_d, p_d, d=2), **kw)
    want = jeng.run(_reqs(JaxRequest, specs))
    got = eng.run(_reqs(Request, specs))
    _assert_same(got, want)
    _assert_same(got, _generate_each(cfg_t, p_t, _reqs(Request, specs)))
    assert (eng.n_spec_proposed, eng.n_spec_accepted, eng.n_prefills) == (
        jeng.n_spec_proposed, jeng.n_spec_accepted, jeng.n_prefills)
    assert eng.n_spec_proposed > 0 and eng.n_prefix_hits == 0
    assert (eng.pages_budget, eng.pages_highwater, eng.n_pages_allocated) \
        == (jeng.pages_budget, jeng.pages_highwater, jeng.n_pages_allocated)
    assert eng.pages_in_use == 0 and eng.pool_d["dense"]["k"].shape[1] == 8


# ---------------------------------------------------------- the launcher
@pytest.mark.parametrize("extra,mode", [
    ([], "continuous"), (["--grow", "gpt-micro", "--speculate"],
                         "speculative")])
def test_serve_launcher_serves_paged_on_cpu(capsys, extra, mode):
    launch_serve.main(["--arch", "gpt-micro-big", "--engine", "continuous",
                       "--pool", "paged", "--pages", "9", "--batch", "4",
                       "--prompt-len", "12", "--gen", "4", "--capacity",
                       "3", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert "[serve] page budget: 9 pages" in out
    assert f"[{mode}] transformer/full (paged pool) on cpu served 4 " \
           "requests / 16 tokens" in out
    assert "9 pages budget" in out and "pages peak (8 tok/page)" in out
    assert "prefix hit rate" in out
