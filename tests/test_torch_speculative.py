"""The port's greedy speculative serving against the JAX package (CPU).

The chunk-verify kernel's plain version is held against the JAX oracle
and the Pallas kernel in interpret mode; ``verify_step_slots`` /
``commit_slots`` against JAX's hooks on converted weights; and the
speculative engine against the JAX speculative engine (default ``jnp``
kernels) and the port's own non-speculative ``generate``: tokens,
proposal / acceptance counts and host syncs exactly equal.  The CUDA
kernel is held against the plain version in ``test_torch_gpu.py``.
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
from repro.launch.serve import build_params as jax_build_params
from repro.models import get_family as jax_family
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SpeculativeConfig as JaxSpeculativeConfig
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    chunk_verify_attention as cuda_chunk,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.models import transformer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SpeculativeConfig,
    spec_pair_supported,
)
from repro_torch.serve.speculative import make_speculative_loop

MAX_LEN = 32
BF16_TOL = dict(atol=5e-3, rtol=1e-2)  # one bf16 rounding of the output


# ------------------------------------------------------------- the kernel
def _chunk_inputs(seed, B, S, H, KV, Sc, hd, dtype):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    return (rnd(B, S, H, hd), rnd(B, Sc, KV, hd), rnd(B, Sc, KV, hd),
            rnd(B, S, KV, hd), rnd(B, S, KV, hd))


@pytest.mark.parametrize("ring,window,G,dtype", [
    (ring, window, G, "float32") for ring in (False, True)
    for window in (None, 8) for G in (1, 2, 4)] + [
    (False, None, 2, "bfloat16"), (True, 8, 4, "bfloat16")])
def test_chunk_verify_plain_matches_jax_ref_and_pallas(ring, window, G,
                                                       dtype):
    """Offsets -1 (done: exact zeros), 0, 1, mid, Sc and, on the ring, two
    wrapped offsets; f32 within 1e-5, bf16 within one output rounding."""
    B, S, KV, Sc, hd = 7, 5, 2, 32, 16
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    q, ck, cv, k, v = _chunk_inputs(G * 10 + ring, B, S, G * KV, KV, Sc, hd,
                                    jdt)
    offsets = np.array([-1, 0, 1, 13, Sc, Sc + 5, 2 * Sc + 3], np.int32)
    if not ring:
        offsets[5:] = [Sc - 1, 7]
    jin = [jnp.asarray(a) for a in (q, ck, cv, k, v)]
    kw = dict(ring=ring, window=window)
    want_ref = jops.chunk_verify_attention(*jin, jnp.asarray(offsets),
                                           mode="reference", **kw)
    want_pallas = jops.chunk_verify_attention(*jin, jnp.asarray(offsets),
                                              mode="interpret", **kw)
    tin = [torch.from_numpy(np.asarray(a, np.float32)) for a in
           (q, ck, cv, k, v)]
    if dtype == "bfloat16":
        tin = [t.bfloat16() for t in tin]
    got = ops.chunk_verify_attention(*tin, torch.from_numpy(offsets), **kw)
    assert got.dtype == tin[0].dtype and got.shape == (B, S, G * KV, hd)
    assert (got[0] == 0).all()
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-5, rtol=0)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S,ring,window,G", [
    (17, False, None, 1), (17, True, 8, 2), (33, False, 8, 4),
    (33, True, None, 2)])
def test_chunk_verify_plain_matches_pallas_past_16_keys(S, ring, window, G):
    """Chunks of d + 1 = 17 and 33 keys (speculation depth 16 and 32), past
    one tile of the CUDA body's 32 positions and 16 query rows: the plain
    version against the JAX oracle and the Pallas kernel, whose block spans
    the whole chunk.  Offsets -1 (done), 0, 1, mid, Sc and, on the ring,
    two wrapped ones; f32 within 1e-5."""
    B, KV, Sc, hd = 7, 2, 48, 16
    q, ck, cv, k, v = _chunk_inputs(S + G, B, S, G * KV, KV, Sc, hd,
                                    np.float32)
    offsets = np.array([-1, 0, 1, 21, Sc, Sc + 5, 3 * Sc + 7], np.int32)
    if not ring:
        offsets[5:] = [Sc - 1, 40]
    kw = dict(ring=ring, window=window)
    jin = [jnp.asarray(a) for a in (q, ck, cv, k, v)]
    want = [jops.chunk_verify_attention(*jin, jnp.asarray(offsets), mode=m,
                                        **kw)
            for m in ("reference", "interpret")]
    got = ops.chunk_verify_attention(
        *(torch.from_numpy(a) for a in (q, ck, cv, k, v)),
        torch.from_numpy(offsets), **kw)
    assert got.shape == (B, S, G * KV, hd) and (got[0] == 0).all()
    for w in want:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_chunk_verify_done_folds_into_offsets_and_cpu_takes_plain():
    """``done`` rows give exact zeros; CPU tensors go to the plain version
    without touching the CUDA wrapper, which refuses them."""
    q, ck, cv, k, v = (torch.from_numpy(a) for a in _chunk_inputs(
        3, 3, 4, 4, 2, 16, 64, np.float32))
    offsets = torch.tensor([5, 9, 16], dtype=torch.int32)
    done = torch.tensor([False, True, False])
    n0 = cuda_chunk.launches
    got = ops.chunk_verify_attention(q, ck, cv, k, v, offsets, ring=False,
                                     done=done)
    want = ref.chunk_verify_attention_ref(
        q, ck, cv, k, v, torch.tensor([5, -1, 16], dtype=torch.int32),
        ring=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[1] == 0).all() and cuda_chunk.launches == n0
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_chunk(q, ck, cv, k, v, offsets, ring=False)


# ---------------------------------------------------------- the two hooks
@pytest.fixture(scope="module")
def gpt():
    jcfg = jax_get_config("gpt-micro-big")
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


def _prefilled(jcfg, tcfg, jp, tp, B, P, max_len, seed):
    """Both frameworks' pools after a prefill of the same (B, P) prompts."""
    toks = lm_batch(jcfg.vocab_size, B, P, seed=seed)
    jfam = jax_family(jcfg)
    _, jcache = jfam.prefill_full(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  jfam.init_cache(jcfg, B, max_len))
    tcache = transformer.init_cache(tcfg, B, max_len)
    transformer.prefill_full(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             tcache)
    return jcache, tcache


def test_verify_step_slots_matches_jax_and_leaves_the_pool(gpt):
    jcfg, tcfg, jp, tp = gpt
    B, S = 4, 5
    jcache, tcache = _prefilled(jcfg, tcfg, jp, tp, B, 12, MAX_LEN, seed=4)
    rng = np.random.default_rng(5)
    chunk = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.array([3, 12, 7, 30], np.int32)  # row 3 overshoots
    done = np.array([False, False, True, False])
    want, jpend = jax_family(jcfg).verify_step_slots(
        jp, jnp.asarray(chunk), jnp.asarray(positions), jcache, jcfg,
        done=jnp.asarray(done))
    before = {n: t.clone() for n, t in tcache["dense"].items()}
    got, tpend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions), tcache,
        tcfg, done=torch.from_numpy(done))
    live = ~done
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=F32_ATOL)
    for name in ("k", "v"):
        assert torch.equal(tcache["dense"][name], before[name])
        assert tpend["dense"][name].shape == jpend["dense"][name].shape
        np.testing.assert_allclose(tpend["dense"][name].numpy(),
                                   np.asarray(jpend["dense"][name]),
                                   atol=F32_ATOL)
    none, pend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions), tcache,
        tcfg, done=torch.from_numpy(done), logits=False)
    assert none is None
    torch.testing.assert_close(pend["dense"]["k"], tpend["dense"]["k"],
                               rtol=0, atol=0)


def test_commit_slots_matches_jax_prefix_and_keeps_idle_rows(gpt):
    """The committed prefix equals JAX's ``commit_slots``; rows with
    ``n_feed == 0`` or ``done`` keep their pool rows bit-for-bit, and a
    row at the end of the cache commits without an out-of-range write."""
    jcfg, tcfg, jp, tp = gpt
    B, S, P = 5, 5, 10
    jcache, tcache = _prefilled(jcfg, tcfg, jp, tp, B, P, MAX_LEN, seed=6)
    rng = np.random.default_rng(7)
    chunk = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.array([P, P, 4, P, MAX_LEN - 2], np.int32)
    n_feed = np.array([0, 2, S, 3, 1], np.int32)
    done = np.array([False, False, False, True, False])
    jfam = jax_family(jcfg)
    _, jpend = jfam.verify_step_slots(jp, jnp.asarray(chunk),
                                      jnp.asarray(positions), jcache, jcfg)
    want = jfam.commit_slots(jp, jnp.asarray(chunk), jnp.asarray(positions),
                             jnp.asarray(n_feed), jcache, jpend, jcfg,
                             done=jnp.asarray(done))
    _, tpend = transformer.verify_step_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions), tcache,
        tcfg)
    before = {n: t.clone() for n, t in tcache["dense"].items()}
    got = transformer.commit_slots(
        tp, torch.from_numpy(chunk), torch.from_numpy(positions),
        torch.from_numpy(n_feed), tcache, tpend, tcfg,
        done=torch.from_numpy(done))
    assert got is tcache
    for name in ("k", "v"):
        g, w = got["dense"][name].numpy(), np.asarray(want["dense"][name])
        for b in range(B):
            end = positions[b] + (0 if done[b] else n_feed[b])
            np.testing.assert_allclose(g[:, b, :end], w[:, b, :end],
                                       atol=F32_ATOL, err_msg=f"row {b}")
            # the rest is dropped: nothing past the committed prefix moves
            assert torch.equal(got["dense"][name][:, b, end:],
                               before[name][:, b, end:]), f"row {b}"
        for b in (0, 3):  # n_feed 0, done
            assert torch.equal(got["dense"][name][:, b], before[name][:, b])


# ------------------------------------------------------- speculative engine
def _requests(make, vocab, specs, seed0, uid0=0):
    return [make(uid=uid0 + i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)
                 [0], max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _generate_each(cfg, params, reqs, max_len=MAX_LEN):
    return {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens, max_len=max_len,
                            eos_id=r.eos_id)[0].numpy() for r in reqs}


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")


def _spec_engine(cfg, params, cfg_d, params_d, d, **kw):
    kw = dict(dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2), **kw)
    return ContinuousBatchingEngine(
        cfg, params, speculative=SpeculativeConfig(cfg_d, params_d, d=d),
        **kw)


def _jax_spec_engine(cfg, params, cfg_d, params_d, d, **kw):
    kw = dict(dict(capacity=2, max_len=MAX_LEN, prefill_bucket=4, k=2), **kw)
    return JaxEngine(cfg, params,
                     speculative=JaxSpeculativeConfig(cfg_d, params_d, d=d),
                     **kw)


def _assert_same_counts(eng, jeng):
    """Tokens aside, the port's engine did what JAX's did: the same
    proposals, acceptances, prefills, dispatches and host syncs.  Both
    count the draft's admission prefill beside the target's, two prefills
    an admission group, and one host sync a group and a dispatch."""
    assert (eng.n_spec_proposed, eng.n_spec_accepted, eng.n_prefills,
            eng.n_decode_dispatches, eng.n_host_syncs, eng.n_tokens) == (
        jeng.n_spec_proposed, jeng.n_spec_accepted, jeng.n_prefills,
        jeng.n_decode_dispatches, jeng.n_host_syncs, jeng.n_tokens)
    groups, odd = divmod(eng.n_prefills, 2)
    assert not odd and groups > 0
    assert eng.n_host_syncs == groups + eng.n_decode_dispatches


@pytest.fixture(scope="module")
def grown_pair():
    """The paper's pair: gpt-micro (the source) and gpt-micro-big grown
    from it by Mango, made by JAX and converted."""
    jcfg_t = jax_get_config("gpt-micro-big")
    jp_t, jcfg_s, jp_s = jax_build_params(
        jcfg_t, grow_from="gpt-micro", grow_method="mango",
        return_source=True, log_fn=lambda *_: None)
    assert jcfg_s.name == "gpt-micro"
    jp_t, jp_s = (jax.tree.map(np.asarray, p) for p in (jp_t, jp_s))
    return (jcfg_t, jcfg_s, jp_t, jp_s, port_config(jcfg_t),
            port_config(jcfg_s), from_jax(jp_t), from_jax(jp_s))


@pytest.mark.parametrize("d", [2, 4])
def test_spec_exact_grown_pair_matches_jax_and_generate(grown_pair, d):
    """The pretrained source drafts for the target grown from it; more
    requests than slots.  Tokens equal the JAX speculative engine's and
    the port's own ``generate``; the counts equal JAX's."""
    jcfg_t, jcfg_s, jp_t, jp_s, cfg_t, cfg_s, p_t, p_s = grown_pair
    specs = [(4, 7), (9, 3), (6, 9), (5, 2), (11, 5)]
    jeng = _jax_spec_engine(jcfg_t, jp_t, jcfg_s, jp_s, d)
    want = jeng.run(_requests(JaxRequest, jcfg_t.vocab_size, specs, 70))
    eng = _spec_engine(cfg_t, p_t, cfg_s, p_s, d)
    reqs = _requests(Request, cfg_t.vocab_size, specs, 70)
    got = eng.run(reqs)
    _assert_same(got, want)
    _assert_same(got, _generate_each(cfg_t, p_t, reqs))
    _assert_same_counts(eng, jeng)
    assert len(reqs) > eng.capacity and eng.n_spec_proposed > 0
    assert 0.0 <= eng.acceptance_rate <= 1.0 and eng.n_spec_fallbacks == 0


def test_spec_depth_16_pair_matches_jax_and_generate(grown_pair):
    """d = 16: verify chunks of 17 keys, past the 16 that the CUDA verify
    kernels once took.  The pair probe accepts it; the port's engine
    (plain versions on the CPU) gives the JAX speculative engine's tokens
    and counts, and its own ``generate``'s tokens."""
    jcfg_t, jcfg_s, jp_t, jp_s, cfg_t, cfg_s, p_t, p_s = grown_pair
    d, max_len = 16, 64
    ok, why = spec_pair_supported(cfg_t, cfg_s, d=d, max_len=max_len)
    assert ok, why
    specs = [(4, 21), (9, 18), (6, 30)]
    jeng = _jax_spec_engine(jcfg_t, jp_t, jcfg_s, jp_s, d, max_len=max_len)
    want = jeng.run(_requests(JaxRequest, jcfg_t.vocab_size, specs, 90))
    eng = _spec_engine(cfg_t, p_t, cfg_s, p_s, d, max_len=max_len)
    reqs = _requests(Request, cfg_t.vocab_size, specs, 90)
    got = eng.run(reqs)
    _assert_same(got, want)
    _assert_same(got, _generate_each(cfg_t, p_t, reqs, max_len=max_len))
    _assert_same_counts(eng, jeng)
    assert len(reqs) > eng.capacity and eng.n_spec_proposed > 0


@pytest.fixture(scope="module")
def gqa():
    jcfg = tiny_gqa()
    jp, tp = both_params(jcfg)
    return jcfg, port_config(jcfg), jp, tp


def test_spec_self_draft_accepts_everything(gqa):
    """draft == target: greedy acceptance is exactly 1.0 (budget clipping
    is not counted as rejection), tokens equal ``generate``."""
    _, cfg, _, params = gqa
    reqs = _requests(Request, cfg.vocab_size, [(3, 9), (7, 11), (5, 6)], 20)
    eng = _spec_engine(cfg, params, cfg, params, d=3)
    _assert_same(eng.run(reqs), _generate_each(cfg, params, reqs))
    assert eng.n_spec_proposed > 0 and eng.acceptance_rate == 1.0


def test_spec_eos_mid_chunk(gpt):
    """An eos strictly inside a verify chunk truncates the commit there;
    the neighbour slot is unaffected; JAX's engine agrees."""
    jcfg, cfg, jp, params = gpt
    specs = [(6, 12), (8, 12)]
    base = _generate_each(cfg, params, _requests(Request, cfg.vocab_size,
                                                 specs, 30))
    d = 4
    eos, stop = next((int(base[0][i]), i + 1) for i in range(1, d)
                     if int(np.argmax(base[0] == base[0][i])) == i)
    reqs = _requests(Request, cfg.vocab_size, specs, 30)
    reqs[0].eos_id = eos
    got = _spec_engine(cfg, params, cfg, params, d).run(reqs)
    np.testing.assert_array_equal(got[0], base[0][:stop])
    np.testing.assert_array_equal(got[1], base[1])
    jreqs = _requests(JaxRequest, jcfg.vocab_size, specs, 30)
    jreqs[0].eos_id = eos
    _assert_same(got, _jax_spec_engine(jcfg, jp, jcfg, jp, d).run(jreqs))
    assert 1 < stop < d + 1


def test_spec_pair_probe_rejections(gpt, gqa):
    """Vocab mismatch, d < 1 and a window config are refused, naming the
    failing side; the engine refuses before allocating anything, and a
    draft in another compute dtype raises instead of being cast."""
    _, cfg_t, _, params = gpt
    _, cfg_g, _, _ = gqa
    ok, why = spec_pair_supported(cfg_t, cfg_g)
    assert not ok and "vocab" in why
    ok, why = spec_pair_supported(cfg_t, cfg_t, d=0)
    assert not ok and "d must be >= 1" in why
    windowed = port_config(tiny_gqa(window=8))
    ok, why = spec_pair_supported(cfg_g, windowed)
    assert not ok and "draft 'tiny-gqa': NOT SERVABLE" in why
    assert "target 'tiny-gqa': ok" in why and "sliding-window" in why
    with pytest.raises(NotImplementedError, match="vocab"):
        _spec_engine(cfg_t, {}, cfg_g, {}, d=2)
    with pytest.raises(ValueError, match="compute_dtype"):
        _spec_engine(cfg_t, params,
                     cfg_t.replace(name="bf16-draft",
                                   compute_dtype="bfloat16"), params, d=2)
    with pytest.raises(NotImplementedError, match="sampling slice"):
        make_speculative_loop(cfg_t, cfg_t, 2, 2, sampling=object())


def _perturbed(params, scale=3e-3, seed=1):
    """A draft that ALMOST agrees with the target: acceptance lands
    strictly between 0 and 1, so blocks commit partially."""
    gen = torch.Generator().manual_seed(seed)

    def nudge(t):
        if isinstance(t, dict):
            return {k: nudge(v) for k, v in t.items()}
        return t + scale * torch.randn(t.shape, generator=gen)

    return nudge(params)


def test_spec_slot_reuse_no_stale_state(gqa):
    """A recycled slot sees what a fresh engine would: eviction and
    admission overwrite BOTH pools."""
    _, cfg, _, params = gqa
    draft = _perturbed(params)
    wave1 = _requests(Request, cfg.vocab_size, [(8, 6), (11, 6)], 10)
    wave2 = _requests(Request, cfg.vocab_size, [(5, 8), (9, 3)], 90,
                      uid0=100)
    eng = _spec_engine(cfg, params, cfg, draft, d=3)
    eng.run(wave1)
    _assert_same(eng.run(wave2), _generate_each(cfg, params, wave2))
    assert 0.0 < eng.acceptance_rate < 1.0


def test_spec_budget_at_max_len(gqa):
    """prompt + budget == max_len, at a max_len that is its own padded
    cache length (64): the draft's proposals past the budget would write
    past the cache; tokens still equal ``generate`` and JAX's engine."""
    jcfg, cfg, jp, params = gqa
    max_len = 64
    assert transformer.init_cache(cfg, 1, max_len)["dense"]["k"].shape[2] \
        == max_len
    specs = [(50, 14), (61, 3), (20, 44)]
    kw = dict(max_len=max_len, capacity=2)
    draft = _perturbed(params, seed=2)
    got = _spec_engine(cfg, params, cfg, draft, 4, **kw).run(
        _requests(Request, cfg.vocab_size, specs, 40))
    _assert_same(got, _generate_each(
        cfg, params, _requests(Request, cfg.vocab_size, specs, 40), max_len))
    jdraft = jax.tree.map(lambda t: np.asarray(t.numpy()), draft)
    _assert_same(got, _jax_spec_engine(jcfg, jp, jcfg, jdraft, 4, **kw).run(
        _requests(JaxRequest, jcfg.vocab_size, specs, 40)))


def test_spec_draft_fault_falls_back_to_plain_decode(gqa):
    """NaN in one draft weight: the engine drops to the plain macro loop
    once, tokens equal the target-only run, and JAX's engine does the
    same."""
    jcfg, cfg, jp, params = gqa
    specs = [(5, 9), (7, 12), (4, 6)]
    draft = _perturbed(params, scale=0.0)
    draft["final_norm"]["scale"][0] = float("nan")
    eng = _spec_engine(cfg, params, cfg, draft, d=3)
    got = eng.run(_requests(Request, cfg.vocab_size, specs, 60))
    _assert_same(got, _generate_each(cfg, params, _requests(
        Request, cfg.vocab_size, specs, 60)))
    assert eng.n_spec_fallbacks == 1 and eng.n_quarantined == 0
    jdraft = jax.tree.map(np.asarray, jp)
    jdraft["final_norm"]["scale"] = jdraft["final_norm"]["scale"].copy()
    jdraft["final_norm"]["scale"][0] = np.nan
    jeng = _jax_spec_engine(jcfg, jp, jcfg, jdraft, 3)
    _assert_same(got, jeng.run(_requests(JaxRequest, jcfg.vocab_size, specs,
                                         60)))
    assert jeng.n_spec_fallbacks == eng.n_spec_fallbacks
    assert eng.n_host_syncs == jeng.n_host_syncs


# ------------------------------------------------------------ the launcher
def test_serve_launcher_speculates_with_the_grown_source(capsys):
    launch_serve.main(["--arch", "gpt-micro-big", "--engine", "continuous",
                       "--grow", "gpt-micro", "--speculate", "--spec-d", "3",
                       "--batch", "3", "--prompt-len", "8", "--gen", "5",
                       "--capacity", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] speculative pair: target 'gpt-micro-big': ok" in out
    assert "[speculative]" in out and "served 3 requests / 15 tokens" in out
    assert "draft=gpt-micro d=3 acceptance" in out
    params, cfg_src, params_src = launch_serve.build_params(
        get_config("gpt-micro-big"), grow_from="gpt-micro", device="cpu",
        return_source=True, log_fn=lambda *_: None)
    assert cfg_src.name == "gpt-micro"
    assert params_src["embed"].shape[1] == cfg_src.d_model
    assert params["embed"].shape[1] == get_config("gpt-micro-big").d_model


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "continuous", "--speculate"], "needs a draft model"),
    (["--speculate", "--draft", "gpt-micro"], "requires --engine continuous"),
    (["--engine", "continuous", "--speculate", "--draft", "gpt-micro",
      "--spec-d", "0"], "cannot serve this draft/target pair"),
])
def test_serve_launcher_speculate_errors(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        launch_serve.main(["--arch", "gpt-micro-big", "--device", "cpu",
                           *argv])
