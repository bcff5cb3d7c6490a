"""The port's griffin family (recurrentgemma) against the JAX package (CPU).

Configs field for field; the three plain kernel versions (ring decode,
paged ring decode, the RG-LRU scan) against JAX's oracles and its Pallas
kernels in interpret mode; RoPE, banded attention and the ring-cache
helpers; the model's forward, prefill / decode, admission prefill and slot
decode on converted weights (f32 logits within ``F32_ATOL``: the port's
scan runs the recurrence step by step where JAX runs
``lax.associative_scan``, so sums round differently); done rows' state bit
for bit; and the engine, dense and paged under page pressure, against
JAX's engine (``decode_kernel="jnp"``): tokens and counters equal.  The
CUDA kernels are held against the plain versions in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, port_config
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import get_family as jax_family
from repro.models import griffin as jgriffin
from repro.models import rope as jrope
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    paged_ring_decode_attention as cuda_paged_ring,
)
from repro_torch.kernels.decode_attention import (
    ring_decode_attention as cuda_ring,
)
from repro_torch.kernels.rglru_scan import rglru_scan as cuda_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.models import attention, griffin, rope
from repro_torch.models import get_family, paged_groups, serve_supported
from repro_torch.models import spec_decode_supported
from repro_torch.serve import ContinuousBatchingEngine, Request
from repro_torch.serve import paged

MAX_LEN = 64  # griffin-micro's window is 16: rings wrap
GRIFFIN_CONFIGS = ("recurrentgemma-2b", "recurrentgemma-2b-smoke",
                   "griffin-micro", "griffin-micro-big")
BF16_TOL = dict(atol=5e-3, rtol=1e-2)  # one bf16 rounding of the output


def _params(jcfg, seed=0):
    """JAX-initialised params redrawn from seeded numpy: the embedding at
    std 0.02, every other matrix at std 0.2 and the norm scales at 1 +-
    0.1 (at JAX's init the scaled, tied embedding dominates the residual
    and greedy decoding repeats its last token); returns (numpy tree for
    JAX, tensors for the port)."""
    init = jax.jit(lambda key: jax_family(jcfg).init(key, jcfg))
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "lam" in name:
            return a
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        std = 0.02 if "embed" in name else 0.2
        return (std * rng.standard_normal(a.shape)).astype(a.dtype)

    p = jax.tree_util.tree_map_with_path(redraw, p)
    return p, from_jax(p)


def _jitted(jcfg, name):
    """A JAX family entry point jitted with the config closed over (the
    eager per-op dispatch of a decode loop would dominate these tests)."""
    fn = getattr(jax_family(jcfg), name)
    if name in ("decode_step", "decode_step_slots"):
        def call(params, tokens, pos, cache, **kw):
            return fn(params, tokens, pos, cache, jcfg, **kw)
    else:
        def call(params, batch, cache):
            return fn(params, batch, jcfg, cache)
    return jax.jit(call)


@pytest.fixture(scope="module")
def micro():
    jcfg = jax_get_config("griffin-micro")
    jp, tp = _params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("recurrentgemma-2b-smoke")
    jp, tp = _params(jcfg, seed=1)
    return jcfg, port_config(jcfg), jp, tp


def test_griffin_configs_equal_the_reference():
    for name in GRIFFIN_CONFIGS:
        assert get_config(name) == port_config(jax_get_config(name)), name
    cfg = get_config("recurrentgemma-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.lru_width, cfg.window, cfg.vocab_size) == (
        26, 2560, 10, 1, 256, 2560, 2048, 256000)
    assert griffin.block_pattern(cfg).count("attn") == 8


def test_family_protocol_and_probes():
    cfg = get_config("griffin-micro")
    assert get_family(cfg) is griffin
    assert serve_supported(cfg) == (True, jgriffin.serve_supported(
        jax_get_config("griffin-micro"))[1])
    assert paged_groups(cfg) == {"attn": ("seq", ("k", "v"))}
    ok, why = spec_decode_supported(cfg)
    assert not ok and "chunk-verify" in why
    rec_only = cfg.replace(block_pattern=("rec", "rec"), n_layers=2)
    assert paged_groups(rec_only) == {}
    assert griffin.slot_cache_layout(rec_only) == "recurrent"


# ------------------------------------------------------- the plain kernels
def _rnd(rng, *shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def _t(a, dtype="float32"):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.bfloat16() if dtype == "bfloat16" else t


@pytest.mark.parametrize("positions", [[3, 9, 0, -1], [15, 40, 101, 16]])
@pytest.mark.parametrize("G,dtype", [(1, "float32"), (4, "float32"),
                                     (10, "float32"), (4, "bfloat16")])
def test_ring_plain_matches_jax_ref_and_pallas(positions, G, dtype):
    """Pre-wrap, at the ring, far past it, a done row (-1) and a done flag;
    G up to recurrentgemma's 10: f32 within 1e-5 of JAX's oracle and its
    Pallas kernel, bf16 within one output rounding."""
    B, KV, ring, hd, window = 4, 2 if G < 10 else 1, 16, 32, 10
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(G)
    q, k, v = (_rnd(rng, B, G * KV, hd, dtype=jdt),
               _rnd(rng, B, ring, KV, hd, dtype=jdt),
               _rnd(rng, B, ring, KV, hd, dtype=jdt))
    pos = np.array(positions, np.int32)
    done = np.array([False, True, False, False])
    jin = [jnp.asarray(a) for a in (q, k, v)]
    want = [jops.ring_decode_attention(*jin, jnp.asarray(pos), window=window,
                                       mode=m, done=jnp.asarray(done))
            for m in ("reference", "interpret")]
    got = ops.ring_decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                    torch.from_numpy(pos), window=window,
                                    done=torch.from_numpy(done))
    assert got.shape == (B, G * KV, hd) and (got[1] == 0).all()
    if positions[3] < 0:
        assert (got[3] == 0).all()
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-5, rtol=0)
    for w in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **tol)
    if dtype == "float32":  # the model's plain ring attention agrees too
        model = attention.ring_slot_attend(
            _t(q)[:, None], _t(k), _t(v), torch.from_numpy(pos),
            window=window, done=torch.from_numpy(done) | (
                torch.from_numpy(pos) < 0))[:, 0]
        np.testing.assert_allclose(model.numpy(), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("G,dtype", [(1, "float32"), (10, "float32"),
                                     (2, "bfloat16")])
def test_paged_ring_plain_matches_jax_ref_and_pallas(G, dtype):
    """A seeded permutation of the arena's pages as tables, sentinel
    entries for blocks a row never got (rows short of the ring), rows
    past the wrap, a done row."""
    B, KV, hd, n_pages, page, nblk, window = 5, 1, 32, 13, 8, 3, 20
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(30 + G)
    perm = rng.permutation(n_pages)
    bt = perm[np.arange(B * nblk) % n_pages].astype(np.int32).reshape(
        B, nblk)
    bt[1, 2] = bt[3, 1:] = n_pages  # short rows: blocks with no page
    pos = np.array([30, 11, 70, 5, -1], np.int32)
    q = _rnd(rng, B, G * KV, hd, dtype=jdt)
    k, v = (_rnd(rng, n_pages, page, KV, hd, dtype=jdt) for _ in range(2))
    jin = [jnp.asarray(a) for a in (q, k, v, bt)]
    want = [jops.paged_ring_decode_attention(*jin, jnp.asarray(pos),
                                             window=window, mode=m)
            for m in ("reference", "interpret")]
    got = ops.paged_ring_decode_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), torch.from_numpy(bt),
        torch.from_numpy(pos), window=window)
    assert (got[4] == 0).all()
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-5, rtol=0)
    for w in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_scan_plain_matches_jax_ref_and_pallas(dtype, with_h0):
    """The shapes JAX's kernel test takes (S % 128, W % 256): f32 within
    1e-5 of the sequential oracle and the Pallas kernel, bf16 within one
    output rounding."""
    B, S, W = 2, 256, 256
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(3)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))).astype(
        np.float32).astype(jdt)
    b = (0.1 * rng.standard_normal((B, S, W))).astype(np.float32).astype(jdt)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = [jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0,
                            mode="reference"),
            jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0,
                            mode="interpret", bs=128, bw=256)]
    got = ops.rglru_scan(_t(a, dtype), _t(b, dtype),
                         None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == _t(a, dtype).dtype
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-5, rtol=0)
    for w in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def test_rglru_scan_ragged_and_frozen_positions():
    """No divisibility rule: a ragged (B, S, W); frozen positions (a = 1,
    b = 0) carry h through bit for bit."""
    rng = np.random.default_rng(4)
    B, S, W = 3, 37, 50
    a = rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    a[:, 20:], b[:, 20:] = 1.0, 0.0
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    want = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0))
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got[:, 20:], got[:, 19:20].expand(B, S - 20, W))


def test_cpu_tensors_take_the_plain_versions_and_wrappers_refuse_them():
    """On the CPU ``ops`` runs the plain versions; the CUDA wrappers refuse
    a CPU tensor and name what they do not take (G > 16, hd 32)."""
    q = torch.zeros(2, 4, 64)
    k = torch.zeros(2, 8, 1, 64)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    for fn in (cuda_ring, cuda_paged_ring, cuda_scan):
        fn.launches = 0
    ops.ring_decode_attention(q, k, k, pos, window=4)
    ops.paged_ring_decode_attention(q, k[0][None].expand(3, 8, 1, 64),
                                    k[0][None].expand(3, 8, 1, 64),
                                    torch.zeros(2, 1, dtype=torch.int32),
                                    pos, window=4)
    ops.rglru_scan(torch.ones(1, 3, 2), torch.zeros(1, 3, 2))
    assert cuda_ring.launches == cuda_paged_ring.launches == 0
    assert cuda_scan.launches == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ring(q, k, k, pos, window=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_paged_ring(q, k, k, torch.zeros(2, 1, dtype=torch.int32), pos,
                        window=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_scan(torch.ones(1, 3, 2), torch.zeros(1, 3, 2))
    with pytest.raises(NotImplementedError, match="no backward"):
        cuda_scan(torch.ones(1, 3, 2, requires_grad=True),
                  torch.zeros(1, 3, 2))
    from repro_torch.kernels import decode_attention
    with pytest.raises(ValueError, match="H/KV = 17/1"):
        decode_attention._check_ring("ring", torch.zeros(2, 17, 64), 1, pos,
                                     4, 8)
    with pytest.raises(ValueError, match="head_dim 32"):
        decode_attention._check_ring("ring", torch.zeros(2, 4, 32), 1, pos,
                                     4, 8)
    # the longest band, which both ring kernels cut into pieces
    assert decode_attention._check_ring(
        "ring", torch.zeros(2, 10, 256), 1, pos, 2048, 1000) == 1000
    assert decode_attention._check_ring(
        "ring", torch.zeros(2, 10, 256), 1, pos, 2048, 2048) == 2048


# ------------------------------------------------------------- the pieces
def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = _rnd(rng, 2, 7, 3, 20)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for frac in (1.0, 0.5):
        want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                theta=10000.0, fraction=frac)
        got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta=10000.0, fraction=frac)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_banded_attention_matches_jax():
    """The prefill's windowed attention (query chunks that read only their
    bands' keys) against JAX's, ragged tail included."""
    rng = np.random.default_rng(6)
    q, k, v = _rnd(rng, 2, 45, 4, 8), _rnd(rng, 2, 45, 1, 8), _rnd(
        rng, 2, 45, 1, 8)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=6, chunk_q=16)
    got = attention.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=6, chunk_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ring_helpers_match_jax():
    rng = np.random.default_rng(7)
    cur = np.array([0, 1, 5, 16, 17, 40], np.int32)
    np.testing.assert_array_equal(
        attention.ring_positions_rows(torch.from_numpy(cur), 16).numpy(),
        np.asarray(jattn.ring_positions_rows(jnp.asarray(cur), 16)))
    x = _rnd(rng, 3, 40, 1, 4)
    plens = np.array([3, 16, 37], np.int32)
    np.testing.assert_array_equal(
        attention.ring_fill_rows(torch.from_numpy(x), torch.from_numpy(plens),
                                 16, torch.float32).numpy(),
        np.asarray(jattn.ring_fill_rows(jnp.asarray(x), jnp.asarray(plens),
                                        16, jnp.float32)))


def test_rglru_parallel_and_conv_match_jax(micro):
    """Gates, frozen padded tails and an initial state through the scan;
    the conv tail gathered at each row's own length."""
    jcfg, cfg, jp, tp = micro
    rng = np.random.default_rng(8)
    W = cfg.lru_width
    y = _rnd(rng, 3, 11, W)
    h0 = rng.standard_normal((3, W)).astype(np.float32)
    plens = np.array([11, 4, 7], np.int32)
    valid = np.arange(11)[None] < plens[:, None]
    jbp = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["rec_blocks"])
    tbp = {k: (v[0] if not isinstance(v, dict) else v)
           for k, v in tp["rec_blocks"].items()}
    jh, jlast = jax.jit(jgriffin.rglru_parallel)(
        jnp.asarray(y), jbp, h0=jnp.asarray(h0), valid=jnp.asarray(valid))
    th, tlast = griffin.rglru_parallel(torch.from_numpy(y), tbp,
                                       h0=torch.from_numpy(h0),
                                       valid=torch.from_numpy(valid))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=F32_ATOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               atol=F32_ATOL)
    jo, js = jgriffin._causal_conv(jnp.asarray(y), jbp["conv_w"],
                                   jbp["conv_b"], lengths=jnp.asarray(plens))
    to, ts = griffin._causal_conv(torch.from_numpy(y), tbp["conv_w"],
                                  tbp["conv_b"],
                                  lengths=torch.from_numpy(plens))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -------------------------------------------------------------- the model
@pytest.mark.parametrize("which", ["micro", "smoke"])
def test_forward_logits_match_jax(which, micro, smoke):
    jcfg, cfg, jp, tp = {"micro": micro, "smoke": smoke}[which]
    toks = lm_batch(jcfg.vocab_size, 2, 40, seed=9)
    want, _ = jax.jit(lambda p, b: jgriffin.forward(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    got, aux = griffin.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.shape == (2, 40, cfg.vocab_size) and aux == {"moe_aux": 0.0}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def _assert_tree_close(got, want, atol):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree_close(got[key], want[key], atol)
        else:
            np.testing.assert_allclose(got[key].float().numpy(),
                                       np.asarray(want[key], np.float32),
                                       atol=atol, err_msg=key)


@pytest.mark.parametrize("which", ["micro", "smoke"])
def test_prefill_and_decode_steps_match_jax(which, micro, smoke):
    """``prefill`` then ``decode_step`` past the window (the ring wraps):
    logits and every cache leaf within tolerance at each step."""
    jcfg, cfg, jp, tp = {"micro": micro, "smoke": smoke}[which]
    B, P = 2, 13
    toks = lm_batch(jcfg.vocab_size, B, P, seed=10)
    jfam = jax_family(jcfg)
    jc = jfam.init_cache(jcfg, B, MAX_LEN)
    tc = griffin.init_cache(cfg, B, MAX_LEN)
    jl, jc = _jitted(jcfg, "prefill")(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = griffin.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL)
    rng = np.random.default_rng(11)
    jdecode = _jitted(jcfg, "decode_step")
    for t in range(cfg.window + 8 - P if which == "micro" else 6):
        nxt = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(nxt), P + t, jc)
        tl, tc = griffin.decode_step(tp, torch.from_numpy(nxt), P + t, tc,
                                     cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL)
    _assert_tree_close(tc, jc, F32_ATOL)


@pytest.mark.parametrize("which", ["micro", "smoke"])
def test_prefill_full_and_last_per_row_with_padded_buckets(which, micro,
                                                           smoke):
    """Bucket-padded admission rows: logits at every position and the
    per-row state (conv tails at each row's boundary, frozen h, rings
    filled by absolute position, some past the window) match JAX's;
    ``prefill_last`` gives the rows at each true last position."""
    jcfg, cfg, jp, tp = {"micro": micro, "smoke": smoke}[which]
    plens = np.array([5, 24, 17, 40], np.int32)
    S = 40
    toks = lm_batch(jcfg.vocab_size, 4, S, seed=12)
    toks[np.arange(S)[None] >= plens[:, None]] = 0
    jfam = jax_family(jcfg)
    jl, jc = _jitted(jcfg, "prefill_full")(
        jp, {"tokens": jnp.asarray(toks), "plens": jnp.asarray(plens)},
        jfam.init_cache(jcfg, 4, MAX_LEN))
    tl, tc = griffin.prefill_full(tp, {"tokens": torch.from_numpy(toks),
                                       "plens": torch.from_numpy(plens)}, cfg,
                                  griffin.init_cache(cfg, 4, MAX_LEN))
    for b, n in enumerate(plens):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl[b, :n]),
                                   atol=F32_ATOL)
    _assert_tree_close(tc, jc, F32_ATOL)
    last, tc2 = griffin.prefill_last(tp, torch.from_numpy(toks),
                                     torch.from_numpy(plens), cfg,
                                     griffin.init_cache(cfg, 4, MAX_LEN))
    np.testing.assert_allclose(
        last.numpy(), np.asarray(jl)[np.arange(4), plens - 1], atol=F32_ATOL)
    _assert_tree_close(tc2, jc, F32_ATOL)


def test_decode_step_slots_match_jax_and_done_rows_stay_bit_identical(
        micro):
    """Per-row positions (some past the wrap) with a done row: logits and
    the cache match JAX's slot decode; every leaf of the done row, and a
    whole all-done step, leave the pool bit for bit."""
    jcfg, cfg, jp, tp = micro
    B, S = 3, 30
    plens = np.array([30, 9, 21], np.int32)
    toks = lm_batch(jcfg.vocab_size, B, S, seed=13)
    jfam = jax_family(jcfg)
    _, jc = _jitted(jcfg, "prefill_full")(
        jp, {"tokens": jnp.asarray(toks), "plens": jnp.asarray(plens)},
        jfam.init_cache(jcfg, B, MAX_LEN))
    tc = from_jax(jax.tree.map(np.asarray, jc))
    jdecode = _jitted(jcfg, "decode_step_slots")
    pos = plens.copy()
    done = np.array([False, True, False])
    rng = np.random.default_rng(14)
    for _ in range(5):
        nxt = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        before = jax.tree.map(lambda t: t.clone(), tc)
        jl, jc = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                         done=jnp.asarray(done))
        tl, tc = griffin.decode_step_slots(tp, torch.from_numpy(nxt),
                                           torch.from_numpy(pos), tc, cfg,
                                           done=torch.from_numpy(done))
        np.testing.assert_allclose(tl[~done].numpy(),
                                   np.asarray(jl)[~done], atol=F32_ATOL)
        for leaf, old in zip(jax.tree.leaves(tc), jax.tree.leaves(before)):
            assert torch.equal(leaf[:, 1], old[:, 1])
        pos = pos + ~done
    _assert_tree_close(tc, jc, F32_ATOL)
    before = jax.tree.map(lambda t: t.clone(), tc)
    griffin.decode_step_slots(tp, torch.zeros(B, dtype=torch.int32),
                              torch.from_numpy(pos), tc, cfg,
                              done=torch.ones(B, dtype=torch.bool))
    for leaf, old in zip(jax.tree.leaves(tc), jax.tree.leaves(before)):
        assert torch.equal(leaf, old)


# ------------------------------------------------------------- the engine
def _reqs(make, vocab, specs, seed0=50, eos=None):
    return [make(uid=i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g, eos_id=eos)
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


COUNTERS = ("n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_prefix_hits", "n_prefix_misses")

# prompts and budgets whose rings wrap (window 16) before, during or after
# admission, at capacity 3 with recycling
SPECS = [(3, 14), (21, 6), (9, 12), (30, 9), (5, 20), (17, 3)]


@pytest.mark.parametrize("k", [1, 4])
def test_engine_matches_jax_engine_and_generate(micro, k):
    jcfg, cfg, jp, tp = micro
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=4, k=k)
    want = JaxEngine(jcfg, jp, **kw).run(_reqs(JaxRequest, jcfg.vocab_size,
                                               SPECS))
    eng = ContinuousBatchingEngine(cfg, tp, **kw)
    got = eng.run(_reqs(Request, cfg.vocab_size, SPECS))
    _assert_same(got, want)
    _assert_same(got, _generate_each(cfg, tp, _reqs(Request, cfg.vocab_size,
                                                    SPECS)))
    assert eng.cache_layout == "recurrent+ring"
    assert eng.pool["attn"]["k"].shape[2] == 16 < MAX_LEN  # O(window)
    assert len({tuple(t) for t in got.values()}) == len(SPECS)


def test_eos_mid_block_freezes_the_row(micro):
    """An eos inside a K=4 block stops the row there (its recurrent state
    freezes mid-block); the neighbour's tokens stay exact; as JAX's."""
    jcfg, cfg, jp, tp = micro
    specs = [(6, 12), (8, 12)]
    base = _generate_each(cfg, tp, _reqs(Request, cfg.vocab_size, specs,
                                         seed0=31))
    eos = stop = None
    for i in range(1, 3):
        cand = int(base[0][i])
        if int(np.argmax(base[0] == cand)) == i:
            eos, stop = cand, i + 1
            break
    assert eos is not None, "trace has no mid-block eos candidate"
    kw = dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=4)
    reqs = _reqs(Request, cfg.vocab_size, specs, seed0=31)
    reqs[0].eos_id = eos
    got = ContinuousBatchingEngine(cfg, tp, **kw).run(reqs)
    jreqs = _reqs(JaxRequest, cfg.vocab_size, specs, seed0=31)
    jreqs[0].eos_id = eos
    want = JaxEngine(jcfg, jp, **kw).run(jreqs)
    np.testing.assert_array_equal(got[0], base[0][:stop])
    np.testing.assert_array_equal(got[1], base[1])
    _assert_same(got, want)


def _stepped(eng, reqs):
    for r in reqs:
        eng.submit(r)
    trace = []
    while eng.waiting or eng.active:
        eng.step()
        trace.append(sorted(s.req.uid for s in eng.active.values()))
    return trace


def test_paged_engine_under_page_pressure_matches_jax(micro):
    """The ring group pages (page 8, 2 blocks per slot: rings wrap inside
    their pages) and the recurrent group stays dense; 5 pages for a
    capacity of 3 make admissions wait.  Admission trace, tokens and the
    page / sync counters equal JAX's paged engine; tokens equal the dense
    pool's; no page is left in use and no prefix is shared."""
    jcfg, cfg, jp, tp = micro
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=4, k=4,
              pool="paged", pages=5)
    jeng, eng = JaxEngine(jcfg, jp, **kw), ContinuousBatchingEngine(cfg, tp,
                                                                    **kw)
    jtrace = _stepped(jeng, _reqs(JaxRequest, jcfg.vocab_size, SPECS))
    ttrace = _stepped(eng, _reqs(Request, cfg.vocab_size, SPECS))
    assert ttrace == jtrace
    assert any(len(t) < 3 for t in ttrace[:2])  # pages, not slots, bound
    _assert_same(eng.finished, jeng.finished)
    assert {c: getattr(eng, c) for c in COUNTERS} == {
        c: getattr(jeng, c) for c in COUNTERS}
    eng.run(), jeng.run()  # apply the last evictions
    assert eng.pages_in_use == jeng.pages_in_use == 0
    assert eng.pool_kind == "paged"
    assert eng.pages_highwater <= 5 and eng.n_prefix_hits == 0
    assert "bt" in eng.pool["attn"] and "bt" not in eng.pool["rec"]
    assert eng.pool["rec"]["h"].shape[1] == 3  # dense per slot
    dense = ContinuousBatchingEngine(cfg, tp, **dict(kw, pool="dense",
                                                     pages=None))
    _assert_same(eng.finished, dense.run(_reqs(Request, cfg.vocab_size,
                                                SPECS)))


def test_paged_pool_geometry_scatter_and_evict_match_jax(micro):
    """``build_paged_pool`` lays out the ring group as JAX's does (plus
    the scratch page) beside a dense recurrent group; ``admit_scatter``
    and ``evict_clear`` touch the dense group's slots and the paged
    group's pages as JAX's do."""
    from repro.serve import paged as jpaged
    jcfg, cfg, jp, tp = micro
    jpool, jmeta = jpaged.build_paged_pool(jax_family(jcfg), jcfg, 3,
                                           MAX_LEN, pages=7)
    pool, meta = paged.build_paged_pool(griffin, cfg, 3, MAX_LEN, pages=7)
    assert (meta.page, meta.nblk, meta.n_pages) == (jmeta.page, jmeta.nblk,
                                                    jmeta.n_pages) == (8, 2,
                                                                       7)
    assert pool["attn"]["k"].shape[1] == 8  # 7 pages + the scratch page
    for key, grp in jpool.items():
        for name, leaf in grp.items():
            want = leaf.shape if name == "bt" or key == "rec" else (
                leaf.shape[0], 8) + leaf.shape[2:]
            assert tuple(pool[key][name].shape) == tuple(want), (key, name)
    plens = np.array([20, 6], np.int32)
    toks = lm_batch(jcfg.vocab_size, 2, 20, seed=15)
    _, jrows = _jitted(jcfg, "prefill_full")(
        jp, {"tokens": jnp.asarray(toks), "plens": jnp.asarray(plens)},
        jax_family(jcfg).init_cache(jcfg, 2, MAX_LEN))
    rows = from_jax(jax.tree.map(np.asarray, jrows))
    bt_rows = np.array([[4, 1], [6, 7]], np.int32)  # row 1: one page only
    jpool = jpaged.admit_scatter(jpool, jrows, jnp.asarray([2, 0]),
                                 jnp.asarray(bt_rows), jmeta)
    paged.admit_scatter(pool, rows, torch.tensor([2, 0]),
                        torch.from_numpy(bt_rows), meta)
    for key in jpool:
        for name, leaf in jpool[key].items():
            got = pool[key][name]
            if name != "bt" and key == "attn":
                got = got[:, :7]
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf),
                                          err_msg=f"{key}/{name}")
    jpool = jpaged.evict_clear(jpool, jnp.asarray([2, 3, 3]),
                               jnp.asarray([4, 1, 7]), jmeta)
    paged.evict_clear(pool, torch.tensor([2]), torch.tensor([4, 1]), meta)
    for key in jpool:
        for name, leaf in jpool[key].items():
            got = pool[key][name]
            if name != "bt" and key == "attn":
                got = got[:, :7]
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def test_windowed_transformer_still_refuses_the_paged_pool():
    windowed = port_config(JaxConfig(name="win", n_layers=1, d_model=32,
                                     n_heads=2, n_kv_heads=2, d_ff=64,
                                     vocab_size=50, window=8, rope="none"))
    with pytest.raises(NotImplementedError, match="windowed-transformer"):
        paged.require_full_layout(windowed)
    paged.require_full_layout(get_config("griffin-micro"))  # pages


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("extra,pool", [([], "dense"),
                                        (["--pool", "paged", "--pages", "9"],
                                         "paged")])
def test_serve_launcher_serves_griffin_on_cpu(capsys, extra, pool):
    launch_serve.main(["--arch", "recurrentgemma-2b-smoke", "--engine",
                       "continuous", "--batch", "4", "--prompt-len", "40",
                       "--gen", "5", "--capacity", "3", "--device", "cpu",
                       *extra])
    out = capsys.readouterr().out
    assert (f"[continuous] griffin/recurrent+ring ({pool} pool) on cpu "
            "served 4 requests / 20 tokens") in out
    launch_serve.main(["--arch", "recurrentgemma-2b-smoke", "--batch", "2",
                       "--prompt-len", "40", "--gen", "3", "--device", "cpu"])
    assert "[naive] generated 6 tokens" in capsys.readouterr().out
