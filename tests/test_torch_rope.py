"""The port's RoPE dense transformers against the JAX package (CPU).

``convert.from_jax`` on bfloat16 trees; the plain version of
``decode_attention`` against JAX's oracle and its Pallas kernel in
interpret mode; the four RoPE smoke configs (qwen1.5: qkv bias; qwen3:
q/k norms and GQA; stablelm: partial rotary 0.25 and LayerNorm; yi: theta
5e6) and qwen2-vl-72b-smoke (M-RoPE over three equal streams) through
forward, prefill + scalar decode, slot decode with done rows, verify +
commit, and paged decode and verify, on converted weights
(f32 logits within ``F32_ATOL``: the frameworks sum in different orders);
the dense-pool step builders; and the engine on qwen3-0.6b-smoke, dense
and paged under page pressure with prefix hits at K 8 and 16, and
speculative with the model drafting for itself, against JAX's engine:
tokens equal, counters equal.  The CUDA kernel is held against the plain
version in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, port_config, redrawn_params
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jops
from repro.models import get_family as jax_family
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro.serve import paged as jpaged
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.convert import from_jax, to_numpy
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.models import serve_supported, transformer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SpeculativeConfig,
)
from repro_torch.serve import paged
from repro_torch.train import steps

ROPE_SMOKE = ("qwen1.5-0.5b-smoke", "qwen3-0.6b-smoke", "stablelm-3b-smoke",
              "yi-9b-smoke")
# the model routes also run qwen2-vl (M-RoPE), whose routes build three
# equal position streams (tests/test_torch_qwen2vl.py feeds distinct ones)
ROUTE_SMOKE = ROPE_SMOKE + ("qwen2-vl-72b-smoke",)
ROPE_ARCHS = ("stablelm-3b", "qwen1.5-0.5b", "qwen3-0.6b", "yi-9b",
              "yi-9b-half") + ROPE_SMOKE
MAX_LEN = 64  # pad_cache_len(64) = 64: page 8, 8 blocks a slot
BF16_TOL = dict(atol=5e-3, rtol=1e-2)  # one bf16 rounding of the output


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg = jax_get_config(name)
        _MODELS[name] = (jcfg, port_config(jcfg), *redrawn_params(jcfg))
    return _MODELS[name]


def _jitted(jcfg, name):
    """A JAX family entry point jitted with the config closed over."""
    fn = getattr(jax_family(jcfg), name)
    if name in ("decode_step", "decode_step_slots", "verify_step_slots"):
        def call(params, tokens, pos, cache, **kw):
            return fn(params, tokens, pos, cache, jcfg, **kw)
    else:
        def call(params, batch, cache):
            return fn(params, batch, jcfg, cache)
    return jax.jit(call)


def _close(got, want, atol=F32_ATOL, err_msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=err_msg)


def _tree_close(got, want, atol=F32_ATOL):
    for key, w in want.items():
        if isinstance(w, dict):
            _tree_close(got[key], w, atol)
        else:
            _close(got[key], w, atol, err_msg=key)


# ----------------------------------------------------- configs and repair
def test_rope_configs_equal_the_reference_and_serve():
    for name in ROPE_ARCHS:
        cfg = get_config(name)
        assert cfg == port_config(jax_get_config(name)), name
        assert cfg.rope == "standard" and serve_supported(cfg)[0], name
    cfg = get_config("qwen3-0.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.rope_theta,
            cfg.qk_norm, cfg.tie_embeddings, cfg.param_dtype) == (
        28, 1024, 16, 8, 128, 3072, 151936, 1e6, True, True, "bfloat16")
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        transformer.param_shapes(cfg), is_leaf=lambda x: isinstance(
            x, torch.Size)))
    assert n == 596_049_920  # 28 x 15,730,944 + the 155,582,464 embedding


@pytest.mark.parametrize("kw,what", [
    (dict(rope="mrope", mrope_sections=(2, 3, 3)), "mrope"),
    (dict(moe=True, n_experts=4, top_k=2), "MoE"),
    (dict(mla=True, kv_lora_rank=8, q_lora_rank=8, qk_nope_dim=8,
          qk_rope_dim=8, v_head_dim=8), "MLA"),
    (dict(window=8), "sliding-window"),
    (dict(mtp=True), "MTP"),
    (dict(mla=True, kv_lora_rank=8, q_lora_rank=8, qk_nope_dim=8,
          qk_rope_dim=8, v_head_dim=8, window=8), "MLA window")])
def test_unported_variants_still_refused(kw, what):
    """M-RoPE, a sliding window, MoE layers, MLA and the MTP head on qwen3
    are ported (M-RoPE's K/V cache and params, the ring cache, the "moe"
    cache group, or the "ckv"/"kr" latents have JAX's shapes; the "mtp"
    head has JAX's param shapes; each serves as JAX's does), but MLA with
    a window is refused, as JAX refuses it."""
    cfg = get_config("qwen3-0.6b-smoke").replace(**kw)
    if "rope" in kw:
        jcfg = jax_get_config("qwen3-0.6b-smoke").replace(**kw)
        want = jax_family(jcfg).init_cache(jcfg, 1, 40)
        got = transformer.init_cache(cfg, 1, 40)
        assert set(got) == set(want) == {"dense"}
        for name in ("k", "v"):
            assert got["dense"][name].shape == want["dense"][name].shape
        wshapes = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
            lambda: jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg)))
        assert jax.tree.map(tuple, transformer.param_shapes(cfg),
                            is_leaf=lambda x: isinstance(
                                x, torch.Size)) == wshapes
        assert serve_supported(cfg) == jax_family(jcfg).serve_supported(
            jcfg)
        assert serve_supported(cfg)[0]
        return
    if "mla" in kw or "mtp" in kw:
        jcfg = jax_get_config("qwen3-0.6b-smoke").replace(**kw)
        want = jax_family(jcfg).init_cache(jcfg, 1, 40)
        got = transformer.init_cache(cfg, 1, 40)
        assert set(got["dense"]) == set(want["dense"])
        for name in want["dense"]:
            assert got["dense"][name].shape == want["dense"][name].shape
        if "mtp" in kw:
            jmtp = jax.eval_shape(lambda: jax_family(jcfg).init(
                jax.random.PRNGKey(0), jcfg))["mtp"]
            got_mtp = transformer.param_shapes(cfg)["mtp"]
            assert jax.tree.map(lambda s: tuple(s.shape), jmtp) == \
                jax.tree.map(tuple, got_mtp, is_leaf=lambda x: isinstance(
                    x, torch.Size))
        assert serve_supported(cfg) == jax_family(jcfg).serve_supported(
            jcfg)
        assert serve_supported(cfg)[0] == ("window" not in kw)
        return
    if "moe" in kw:
        jcfg = jax_get_config("qwen3-0.6b-smoke").replace(**kw)
        want = jax_family(jcfg).init_cache(jcfg, 1, 40)
        got = transformer.init_cache(cfg, 1, 40)
        assert set(got) == set(want) == {"moe"}
        for name in ("k", "v"):
            assert got["moe"][name].shape == want["moe"][name].shape
        ok, why = serve_supported(cfg)
        assert ok and "full KV cache" in why
        return
    if "window" in kw:
        jcfg = jax_get_config("qwen3-0.6b-smoke").replace(**kw)
        want = jax_family(jcfg).init_cache(jcfg, 1, 40)
        got = transformer.init_cache(cfg, 1, 40)
        assert got["dense"]["k"].shape == want["dense"]["k"].shape
        assert got["dense"]["k"].shape[2] == 8
        ok, why = serve_supported(cfg)
        assert ok and "ring-buffer window" in why
        return
    raise AssertionError(f"no case checks {what}")
    ok, why = serve_supported(cfg)
    assert not ok and what in why


@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_from_jax_carries_bf16_trees_bit_for_bit(name):
    """A bf16 JAX tree converts leaf for leaf with the same 16-bit
    patterns; ``to_numpy`` gives them back as exact float32."""
    jcfg = jax_get_config(name).replace(param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_family(jcfg).init(key, jcfg))(jax.random.PRNGKey(3)))
    tp = from_jax(jp)
    leaves_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    leaves_t = jax.tree.leaves(tp)
    assert len(leaves_j) == len(leaves_t)
    for (path, a), t in zip(leaves_j, leaves_t):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
            np.uint16), a.view(np.uint16), err_msg=str(path))
    for (path, a), back in zip(leaves_j, jax.tree.leaves(to_numpy(tp))):
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, a.astype(np.float32),
                                      err_msg=str(path))


# ------------------------------------------------- decode_attention, plain
def _rnd(rng, *shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def _t(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.bfloat16() if dtype == "bfloat16" else t


_JAX_DECODE = {}  # case -> JAX's (oracle, Pallas) outputs, shared by layouts


@pytest.mark.parametrize("G,hd,S,dtype", [
    (1, 64, 37, "float32"), (2, 128, 300, "float32"),
    (4, 64, 300, "float32"), (8, 128, 37, "float32"),
    (2, 64, 300, "bfloat16"), (8, 128, 37, "bfloat16")])
@pytest.mark.parametrize("layout", ["head-major", "pool view"])
def test_decode_attention_plain_matches_jax_ref_and_pallas(G, hd, S, dtype,
                                                           layout):
    """Per-row lengths (0, 1, ragged, S, past S) with a done row, and a
    scalar length, on S not divisible by 64 (JAX's ``_pick_bk`` takes
    both: 37 is one block, 300 two of 150): f32 within 1e-5 of JAX's
    oracle and its Pallas kernel in interpret mode, bf16 within one output
    rounding.  The port reads either a contiguous head-major cache or the
    pool's (B, S, KV, hd) cache through its ``transpose(1, 2)`` view."""
    B, KV = 5, 2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(G * 1000 + hd + S)
    q = _rnd(rng, B, G * KV, hd, dtype=jdt)
    k, v = (_rnd(rng, B, KV, S, hd, dtype=jdt) for _ in range(2))
    if layout == "pool view":
        tk, tv = (_t(a.transpose(0, 2, 1, 3).copy(), dtype).transpose(1, 2)
                  for a in (k, v))
        assert not tk.is_contiguous() and tk.stride(-1) == 1
    else:
        tk, tv = _t(k, dtype), _t(v, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-5, rtol=0)
    lens = np.array([0, 1, S // 3, S, S + 9], np.int32)
    done = np.array([False, False, False, True, False])
    jin = [jnp.asarray(a) for a in (q, k, v)]
    for kv_len, dn in ((lens, done), (S - 5, None)):
        jkw = {} if dn is None else dict(done=jnp.asarray(dn))
        key = (G, hd, S, dtype, dn is None)
        if key not in _JAX_DECODE:
            _JAX_DECODE[key] = [
                jops.decode_attention(*jin, jnp.asarray(kv_len),
                                      mode="reference", **jkw),
                jops.decode_attention(*jin, jnp.minimum(kv_len, S),
                                      mode="interpret", **jkw)]
        want = _JAX_DECODE[key]
        got = ops.decode_attention(
            _t(q, dtype), tk, tv,
            int(kv_len) if np.ndim(kv_len) == 0 else torch.from_numpy(
                kv_len), done=None if dn is None else torch.from_numpy(dn))
        assert got.shape == (B, G * KV, hd) and got.dtype == _t(q, dtype).dtype
        for w in want:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(w, np.float32), **tol)
        if dn is not None:
            assert (got[0] == 0).all() and (got[3] == 0).all()


def test_decode_attention_wrapper_refuses_and_splits():
    """On the CPU ``ops`` runs the plain version and the CUDA wrapper
    refuses the tensors and head dims past 128 (80 runs in the 128
    bucket); the cache axis is cut as the paged-decode body's
    bands are (``paged_decode_splits`` at the instance's blocks an SM,
    here 3: float32 at hd 64 and 128), in pieces of whole 32-position
    tiles, one thread-block cluster of at most 16 a band."""
    q, k = torch.zeros(2, 4, 64), torch.zeros(2, 2, 70, 64)
    kda.decode_attention.launches = 0
    ops.decode_attention(q, k, k, 5)
    assert kda.decode_attention.launches == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        kda.decode_attention(q, k, k, torch.tensor([5, 5],
                                                   dtype=torch.int32))
    kda._check_heads("decode_attention", 4, 2, 80)  # the 128 bucket
    with pytest.raises(ValueError, match="head_dim 144"):
        kda._check_heads("decode_attention", 4, 2, 144)
    with pytest.raises(ValueError, match="H/KV = 12/1"):
        kda._check_heads("decode_attention", 12, 1, 64)
    # gpt-base generate (B 1, 12 KV heads, 1024 positions): 16 pieces
    assert kda.paged_decode_splits(1, 12, 1024, 132, 3) == (64, 16)
    # qwen3-0.6b at B 8 (8 KV heads): 6 pieces of 192
    assert kda.paged_decode_splits(8, 8, 1024, 132, 3) == (192, 6)
    assert kda.paged_decode_splits(64, 32, 4096, 132, 3) == (4096, 1)
    assert kda.paged_decode_splits(2, 2, 37, 132, 3) == (32, 2)


def test_scalar_decode_step_routes_through_decode_attention(monkeypatch):
    """``decode_step`` reaches ``ops.decode_attention`` once per layer, over
    the cache's head-major view (no copy), with kv_len = pos + 1; prefill
    and slot decode do not."""
    jcfg, cfg, _, tp = _model("qwen3-0.6b-smoke")
    calls = []
    plain = ref.decode_attention_ref

    def spy(q, k, v, kv_len):
        calls.append((k.stride(), kv_len.tolist()))
        return plain(q, k, v, kv_len)

    monkeypatch.setattr(ref, "decode_attention_ref", spy)
    cache = transformer.init_cache(cfg, 2, MAX_LEN)
    toks = torch.from_numpy(lm_batch(cfg.vocab_size, 2, 9, seed=1))
    transformer.prefill(tp, {"tokens": toks}, cfg, cache)
    assert calls == []
    transformer.decode_step(tp, toks[:, 0], 9, cache, cfg)
    Sc, KV, hd = cache["dense"]["k"].shape[2:]
    assert calls == [((Sc * KV * hd, hd, KV * hd, 1), [10, 10])] * \
        cfg.n_layers
    transformer.decode_step_slots(tp, toks[:, 0], torch.tensor([10, 3]),
                                  cache, cfg)
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("name", ROUTE_SMOKE)
def test_forward_matches_jax(name):
    jcfg, cfg, jp, tp = _model(name)
    toks = lm_batch(jcfg.vocab_size, 2, 40, seed=9)
    want, _ = jax.jit(lambda p, b: jax_family(jcfg).forward(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    got, aux = transformer.forward(tp, {"tokens": torch.from_numpy(toks)},
                                   cfg)
    assert got.shape == (2, 40, cfg.vocab_size) and aux == {"moe_aux": 0.0}
    _close(got, want)


@pytest.mark.parametrize("name", ROUTE_SMOKE)
def test_prefill_and_decode_steps_match_jax(name):
    """``prefill`` then scalar ``decode_step`` (the decode_attention
    route): logits at each step and the rotated cache within tolerance."""
    jcfg, cfg, jp, tp = _model(name)
    B, P = 2, 13
    toks = lm_batch(jcfg.vocab_size, B, P, seed=10)
    jl, jc = _jitted(jcfg, "prefill")(jp, {"tokens": jnp.asarray(toks)},
                                      jax_family(jcfg).init_cache(
                                          jcfg, B, MAX_LEN))
    tl, tc = transformer.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 cfg, transformer.init_cache(cfg, B, MAX_LEN))
    _close(tl, jl)
    rng = np.random.default_rng(11)
    jdecode = _jitted(jcfg, "decode_step")
    for t in range(6):
        nxt = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(nxt), P + t, jc)
        tl, tc = transformer.decode_step(tp, torch.from_numpy(nxt), P + t,
                                         tc, cfg)
        _close(tl, jl, err_msg=f"step {t}")
    _tree_close(tc, jc)


def _admitted(jcfg, cfg, jp, plens, S, seed):
    """Bucket-padded admission rows prefilled by JAX (``prefill_full``),
    as numpy-backed caches for both packages, and the port's own
    prefill_full of the same rows, which must agree."""
    B = len(plens)
    toks = lm_batch(jcfg.vocab_size, B, S, seed=seed)
    toks[np.arange(S)[None] >= np.asarray(plens)[:, None]] = 0
    jl, jc = _jitted(jcfg, "prefill_full")(
        jp, {"tokens": jnp.asarray(toks), "plens": jnp.asarray(plens)},
        jax_family(jcfg).init_cache(jcfg, B, MAX_LEN))
    return toks, jl, jax.tree.map(np.asarray, jc)


@pytest.mark.parametrize("name", ROUTE_SMOKE)
def test_slot_decode_with_done_rows_matches_jax(name):
    """Per-row positions after a padded admission prefill, a done row:
    logits of live rows and the cache within tolerance of JAX's slot
    decode; the done row's cache rows stay bit for bit."""
    jcfg, cfg, jp, tp = _model(name)
    plens = np.array([30, 9, 21], np.int32)
    toks, jl0, jc = _admitted(jcfg, cfg, jp, plens, 30, seed=13)
    tl0, tc = transformer.prefill_full(
        tp, {"tokens": torch.from_numpy(toks),
             "plens": torch.from_numpy(plens)}, cfg,
        transformer.init_cache(cfg, 3, MAX_LEN))
    for b, n in enumerate(plens):
        _close(tl0[b, :n], jl0[b, :n])
    _tree_close(tc, jc)
    tc = from_jax(jc)
    jdecode = _jitted(jcfg, "decode_step_slots")
    pos = plens.copy()
    done = np.array([False, True, False])
    rng = np.random.default_rng(14)
    for _ in range(5):
        nxt = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
        before = tc["dense"]["k"][:, 1].clone()
        jl, jc = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                         done=jnp.asarray(done))
        tl, tc = transformer.decode_step_slots(
            tp, torch.from_numpy(nxt), torch.from_numpy(pos), tc, cfg,
            done=torch.from_numpy(done))
        _close(tl[~done], np.asarray(jl)[~done])
        assert torch.equal(tc["dense"]["k"][:, 1, :pos[1]],
                           before[:, :pos[1]])
        pos = pos + ~done
    for name_ in ("k", "v"):
        for b in (0, 2):
            _close(tc["dense"][name_][:, b, :pos[b]],
                   np.asarray(jc["dense"][name_])[:, b, :pos[b]])


@pytest.mark.parametrize("name", ROUTE_SMOKE)
def test_verify_and_commit_match_jax(name):
    """A verify chunk per row at its own offset (one overshooting the
    cache: its proposals rotate past ``max_len``), a done row: logits of
    live rows within tolerance, the cache untouched by verify, and commit
    writes the accepted prefix as JAX's does."""
    jcfg, cfg, jp, tp = _model(name)
    B, S = 4, 5
    plens = np.array([12, 20, 7, 30], np.int32)
    _, _, jc = _admitted(jcfg, cfg, jp, plens, 30, seed=15)
    tc = from_jax(jc)
    rng = np.random.default_rng(16)
    chunk = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.array([12, 20, 7, MAX_LEN - 2], np.int32)
    n_feed = np.array([3, 5, 0, 2], np.int32)
    done = np.array([False, False, True, False])
    jlog, jpend = _jitted(jcfg, "verify_step_slots")(
        jp, jnp.asarray(chunk), jnp.asarray(positions), jc,
        done=jnp.asarray(done))
    before = {n: t.clone() for n, t in tc["dense"].items()}
    tlog, tpend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions), tc, cfg,
        done=torch.from_numpy(done))
    live = ~done
    _close(tlog[live], np.asarray(jlog)[live])
    _close(tpend["dense"]["k"][:, live], np.asarray(jpend["dense"]["k"])[
        :, live])
    for n, t in tc["dense"].items():
        assert torch.equal(t, before[n]), n
    want = jax_family(jcfg).commit_slots(
        jp, jnp.asarray(chunk), jnp.asarray(positions), jnp.asarray(n_feed),
        jc, jpend, jcfg, done=jnp.asarray(done))
    got = transformer.commit_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions),
        torch.from_numpy(n_feed), tc, tpend, cfg,
        done=torch.from_numpy(done))
    for n in ("k", "v"):
        for b in range(B):
            end = positions[b] + (0 if done[b] else n_feed[b])
            _close(got["dense"][n][:, b, :end],
                   np.asarray(want["dense"][n])[:, b, :end],
                   err_msg=f"{n} row {b}")
        assert torch.equal(got["dense"][n][:, 2], before[n][:, 2])


def _with_scratch(a):
    t = torch.from_numpy(np.array(a))
    return torch.cat([t, torch.full_like(t[:, :1], 7.5)], 1)


@pytest.mark.parametrize("name", ROUTE_SMOKE)
def test_paged_decode_and_verify_match_jax(name):
    """The admitted rows scattered over a permuted 20-page arena (a short
    row's table ends in sentinels): slot decode with a done row, then a
    verify chunk and its commit, against JAX's paged pool."""
    jcfg, cfg, jp, tp = _model(name)
    B, n_pages = 3, 20
    plens = np.array([30, 9, 21], np.int32)
    _, _, jrows = _admitted(jcfg, cfg, jp, plens, 30, seed=17)
    jfam = jax_family(jcfg)
    jpool, jmeta = jpaged.build_paged_pool(jfam, jcfg, B, MAX_LEN,
                                           pages=n_pages)
    tpool, tmeta = paged.build_paged_pool(transformer, cfg, B, MAX_LEN,
                                          pages=n_pages)
    perm = np.random.default_rng(18).permutation(n_pages).astype(np.int32)
    bt_rows = np.full((B, jmeta.nblk), n_pages, np.int32)
    bt_rows[0, :6], bt_rows[1, :3], bt_rows[2, :5] = (perm[:6], perm[6:9],
                                                       perm[9:14])
    jpool = jpaged.admit_scatter(jpool, jax.tree.map(jnp.asarray, jrows),
                                 jnp.arange(B), jnp.asarray(bt_rows), jmeta)
    paged.admit_scatter(tpool, from_jax(jrows), torch.arange(B),
                        torch.from_numpy(bt_rows), tmeta)
    jdecode = _jitted(jcfg, "decode_step_slots")
    pos, done = plens.copy(), np.array([False, True, False])
    rng = np.random.default_rng(19)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jpool = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jpool,
                            done=jnp.asarray(done))
        tl, tpool = transformer.decode_step_slots(
            tp, torch.from_numpy(nxt), torch.from_numpy(pos), tpool, cfg,
            done=torch.from_numpy(done))
        _close(tl[~done], np.asarray(jl)[~done])
        pos = pos + ~done
    chunk = rng.integers(0, jcfg.vocab_size, (B, 4)).astype(np.int32)
    n_feed = np.array([4, 0, 2], np.int32)
    jlog, jpend = _jitted(jcfg, "verify_step_slots")(
        jp, jnp.asarray(chunk), jnp.asarray(pos), jpool,
        done=jnp.asarray(done))
    tlog, tpend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(pos), tpool, cfg,
        done=torch.from_numpy(done))
    _close(tlog[~done], np.asarray(jlog)[~done])
    jpool = jfam.commit_slots(jp, jnp.asarray(chunk), jnp.asarray(pos),
                              jnp.asarray(n_feed), jpool, jpend, jcfg,
                              done=jnp.asarray(done))
    transformer.commit_slots(tp, torch.from_numpy(chunk),
                             torch.from_numpy(pos), torch.from_numpy(n_feed),
                             tpool, tpend, cfg, done=torch.from_numpy(done))
    for n in ("k", "v"):
        _close(tpool["dense"][n][:, :n_pages], jpool["dense"][n], err_msg=n)
    np.testing.assert_array_equal(tpool["dense"]["bt"].numpy(),
                                  np.asarray(jpool["dense"]["bt"]))


@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke", "stablelm-3b-smoke"])
def test_prefill_full_and_slot_decode_step_builders_match_jax(name):
    jcfg, cfg, jp, tp = _model(name)
    toks = lm_batch(jcfg.vocab_size, 3, 11, seed=20)
    jl, jc = jsteps.make_prefill_full_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks)},
        jax_family(jcfg).init_cache(jcfg, 3, MAX_LEN))
    tl, tc = steps.make_prefill_full_step(cfg)(
        tp, {"tokens": torch.from_numpy(toks)},
        transformer.init_cache(cfg, 3, MAX_LEN))
    _close(tl, jl)
    pos = np.array([11, 11, 11], np.int32)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    jdec = jax.jit(jsteps.make_slot_decode_step(jcfg))
    tdec = steps.make_slot_decode_step(cfg)
    for _ in range(4):
        jn, jc = jdec(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tn, tc = tdec(tp, torch.from_numpy(nxt), torch.from_numpy(pos), tc)
        assert tn.dtype == torch.int32
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        nxt, pos = np.array(jn), pos + 1
    _tree_close(tc, jc)


# ---------------------------------------------------------------- engine
COUNTERS = ("n_host_syncs", "n_prefills", "n_decode_dispatches", "n_tokens",
            "n_pages_allocated", "pages_highwater", "pages_in_use",
            "n_prefix_hits", "n_prefix_misses")


def _specs(vocab):
    """Eight requests: five open with the same 18 tokens (two full pages
    of 8), three have their own; budgets 6..20 keep rows at positions up
    to ~50.  At capacity 3 over 12 pages the first wave waits for pages
    and later shared-prefix requests hit the pages the first one
    registered."""
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


def _stepped(eng, reqs):
    for r in reqs:
        eng.submit(r)
    trace = []
    while eng.waiting or eng.active:
        eng.step()
        trace.append(sorted(s.req.uid for s in eng.active.values()))
    return trace


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")


@pytest.fixture(scope="module")
def qwen_generated():
    jcfg, cfg, _, tp = _model("qwen3-0.6b-smoke")
    return {r.uid: generate(cfg, tp, torch.from_numpy(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens,
                            max_len=MAX_LEN)[0].numpy()
            for r in _reqs(Request, _specs(cfg.vocab_size))}


@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("k", [8, 16])
def test_engine_matches_jax_engine(pool, k, qwen_generated):
    """qwen3-0.6b-smoke through the engine at capacity 3: the dense pool,
    and a paged pool of 12 pages under page pressure whose later waves
    hit the shared prefix (decode steps over the private tail).  The
    admission trace, tokens and every counter equal JAX's engine; tokens
    equal ``generate`` (the scalar decode_attention route); no page is
    left in use."""
    jcfg, cfg, jp, tp = _model("qwen3-0.6b-smoke")
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=8, k=k, pool=pool,
              pages=12 if pool == "paged" else None)
    specs = _specs(cfg.vocab_size)
    jeng = JaxEngine(jcfg, jp, **kw)
    eng = ContinuousBatchingEngine(cfg, tp, **kw)
    assert _stepped(eng, _reqs(Request, specs)) == _stepped(
        jeng, _reqs(JaxRequest, specs))
    _assert_same(eng.finished, jeng.finished)
    _assert_same(eng.finished, qwen_generated)
    eng.run(), jeng.run()  # apply the last evictions
    assert {c: getattr(eng, c) for c in COUNTERS} == {
        c: getattr(jeng, c) for c in COUNTERS}
    assert len({int(t) for v in eng.finished.values() for t in v}) > 20
    if pool == "paged":
        assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
        assert eng.pages_highwater == 12


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_speculative_engine_drafting_for_itself_matches_jax(pool,
                                                            qwen_generated):
    """qwen3-0.6b-smoke drafting for itself (d 4, K 2; paged: one arena
    of 24 pages for both): every proposal is accepted, and tokens,
    proposals, acceptances, dispatches and syncs equal JAX's speculative
    engine (JAX counts the draft's admission prefill as a second one)."""
    jcfg, cfg, jp, tp = _model("qwen3-0.6b-smoke")
    kw = dict(capacity=3, max_len=MAX_LEN, prefill_bucket=8, k=2, pool=pool,
              pages=24 if pool == "paged" else None)
    specs = _specs(cfg.vocab_size)
    jeng = JaxEngine(jcfg, jp, speculative=JaxSpeculativeConfig(
        jcfg, jp, d=4), **kw)
    eng = ContinuousBatchingEngine(cfg, tp, speculative=SpeculativeConfig(
        cfg, tp, d=4), **kw)
    want = jeng.run(_reqs(JaxRequest, specs))
    got = eng.run(_reqs(Request, specs))
    _assert_same(got, want)
    _assert_same(got, qwen_generated)
    assert (eng.n_spec_proposed, eng.n_spec_accepted,
            eng.n_decode_dispatches, eng.n_host_syncs, eng.n_tokens) == (
        jeng.n_spec_proposed, jeng.n_spec_accepted,
        jeng.n_decode_dispatches, jeng.n_host_syncs, jeng.n_tokens)
    assert eng.n_prefills == jeng.n_prefills
    assert eng.n_spec_accepted == eng.n_spec_proposed > 0
    assert eng.pages_in_use in (None, 0)


@pytest.mark.parametrize("extra,pool", [([], "dense"),
                                        (["--pool", "paged", "--pages", "9"],
                                         "paged")])
def test_serve_launcher_serves_qwen3_on_cpu(capsys, extra, pool):
    launch_serve.main(["--arch", "qwen3-0.6b-smoke", "--engine",
                       "continuous", "--batch", "4", "--prompt-len", "40",
                       "--gen", "5", "--capacity", "3", "--device", "cpu",
                       *extra])
    out = capsys.readouterr().out
    assert (f"[continuous] transformer/full ({pool} pool) on cpu served 4 "
            "requests / 20 tokens") in out
    launch_serve.main(["--arch", "qwen3-0.6b-smoke", "--batch", "2",
                       "--prompt-len", "40", "--gen", "3", "--device", "cpu"])
    assert "[naive] generated 6 tokens" in capsys.readouterr().out


def test_generate_matches_jax_on_a_partial_rotary_gqa_config():
    """A GQA RoPE config built here (not a registered one): 6 query heads
    over 2 KV heads, partial rotary 0.5, theta 1e6 -- ``generate``'s tokens
    equal JAX's ``generate``."""
    from repro.launch.serve import generate as jax_generate
    jcfg = JaxConfig(name="rope-gqa", n_layers=2, d_model=48, n_heads=6,
                     n_kv_heads=2, head_dim=8, d_ff=96, vocab_size=97,
                     rope="standard", rope_fraction=0.5, rope_theta=1e6,
                     act="swiglu", norm="rms", max_seq_len=128)
    cfg = port_config(jcfg)
    jp, tp = redrawn_params(jcfg, seed=4)
    prompts = lm_batch(jcfg.vocab_size, 3, 17, seed=21)
    want = jax_generate(jcfg, jp, jnp.asarray(prompts), max_new_tokens=12)
    got = generate(cfg, tp, torch.from_numpy(prompts), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
