"""The port's transformer against the JAX package on converted weights.

JAX runs its slot decode and admission prefill through the Pallas kernels
in interpret mode (``decode_kernel="interpret"``); the port runs the plain
versions that its kernel wrappers take on CPU tensors.  f32 logits agree
within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, both_params, port_config, tiny_gqa
from repro.configs.base import get_config as jax_get_config
from repro.models import get_family as jax_family
from repro_torch.configs.base import ModelConfig
from repro_torch.models import serve_supported, transformer

CASES = {
    "gpt-micro-big": lambda: jax_get_config("gpt-micro-big"),
    "tiny-gqa": tiny_gqa,
    # biases, tied head, qk-norm, RMSNorm and SwiGLU on random weights
    "tiny-gqa-variants": lambda: tiny_gqa(
        name="tiny-gqa-variants", norm="rms", act="swiglu", qkv_bias=True,
        attn_out_bias=True, mlp_bias=True, qk_norm=True,
        tie_embeddings=True),
}


def _setup(name):
    jcfg = CASES[name]().replace(decode_kernel="interpret")
    jp, tp = both_params(jcfg, randomize=name == "tiny-gqa-variants")
    return jcfg, port_config(jcfg), jp, tp


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_prefill_and_slot_decode_logits(name):
    """forward, prefill_full (flash route at S=24) and decode_step_slots
    (slot route, one done row) logits and cache contents agree."""
    jcfg, tcfg, jp, tp = _setup(name)
    jfam = jax_family(jcfg)
    rng = np.random.default_rng(11)
    B, S, max_len = 3, 24, 40
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    want, _ = jfam.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = transformer.forward(tp, {"tokens": torch.from_numpy(toks)},
                                 tcfg)
    _close(got, want)

    jcache = jfam.init_cache(jcfg, B, max_len)
    tcache = transformer.init_cache(tcfg, B, max_len)
    assert tcache["dense"]["k"].shape == jcache["dense"]["k"].shape
    want, jcache = jfam.prefill_full(jp, {"tokens": jnp.asarray(toks)},
                                     jcfg, jcache)
    got, tcache = transformer.prefill_full(
        tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
    _close(got, want)
    _close(tcache["dense"]["v"], jcache["dense"]["v"])

    # rows continue at their own lengths; row 1 is done (kv_len 0)
    pos = np.array([S, 10, 17], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B,)).astype(np.int32)
    done = np.array([False, True, False])
    want, jcache = jfam.decode_step_slots(
        jp, jnp.asarray(tok), jnp.asarray(pos), jcache, jcfg,
        done=jnp.asarray(done))
    got, tcache = transformer.decode_step_slots(
        tp, torch.from_numpy(tok), torch.from_numpy(pos), tcache, tcfg,
        done=torch.from_numpy(done))
    _close(got, want)
    _close(tcache["dense"]["k"], jcache["dense"]["k"])


@pytest.mark.parametrize("name", ["gpt-micro-big", "tiny-gqa"])
def test_prefill_and_scalar_decode_logits(name):
    """The sequential route ``generate`` runs: prefill (last logits) and
    decode_step at a scalar position, with a prompt length (13) that takes
    the plain route and one (16) that takes the flash route."""
    jcfg, tcfg, jp, tp = _setup(name)
    jfam = jax_family(jcfg)
    rng = np.random.default_rng(12)
    for S in (13, 16):
        toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
        jcache = jfam.init_cache(jcfg, 2, 32)
        tcache = transformer.init_cache(tcfg, 2, 32)
        want, jcache = jfam.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                    jcache)
        got, tcache = transformer.prefill(
            tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
        _close(got, want)
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, _ = jfam.decode_step(jp, jnp.asarray(nxt), jnp.int32(S),
                                   jcache, jcfg)
        got, _ = transformer.decode_step(tp, torch.from_numpy(nxt), S, tcache,
                                         tcfg)
        _close(got, want)


def test_port_init_matches_reference_layout():
    """``init`` draws from a torch.Generator into exactly the reference
    package's param tree: same leaves, shapes and dtypes."""
    jcfg = jax_get_config("gpt-micro")
    want = jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = port_config(jcfg)
    got = transformer.init(torch.Generator().manual_seed(0), cfg)
    again = transformer.init(torch.Generator().manual_seed(0), cfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [(p, w.shape, str(w.dtype)) for p, w in flat_w] == \
        [(p, g.shape, str(g.dtype)) for p, g in flat_g]
    assert torch.equal(got["embed"], again["embed"])


@pytest.mark.parametrize("kw,what", [
    (dict(rope="mrope", mrope_sections=(2, 3, 3)), "RoPE"),
    (dict(mla=True, kv_lora_rank=8, q_lora_rank=8, qk_nope_dim=8,
          qk_rope_dim=8, v_head_dim=8), "MLA"),
    (dict(moe=True, n_experts=4, top_k=2), "MoE"),
    (dict(window=8), "sliding-window"),
    (dict(mla=True, kv_lora_rank=8, q_lora_rank=8, qk_nope_dim=8,
          qk_rope_dim=8, v_head_dim=8, window=8), "MLA window"),
])
def test_unported_configs_raise_naming_roadmap(kw, what):
    """Every variant is ported now.  Multimodal RoPE: its cache and param
    shapes are JAX's and it serves as JAX's does; a sliding window: its
    slot cache is JAX's ring of pad_cache_len(min(max_len, window)) slots
    and it serves; MoE: its cache is JAX's one "moe" group and it serves;
    MLA: its cache is JAX's "ckv"/"kr" latents and it serves, but not
    with a window, which JAX refuses too."""
    cfg = ModelConfig(name="x", rope="none", learned_pos=16).replace(**kw)
    if "rope" in kw:
        jcfg = jax_get_config("gpt-micro").replace(
            **dict(dict(name="x", learned_pos=16), **kw))
        want = jax_family(jcfg).init_cache(jcfg, 2, 20)
        got = transformer.init_cache(port_config(jcfg), 2, 20)
        assert set(got) == set(want) == {"dense"}
        for name in ("k", "v"):
            assert got["dense"][name].shape == want["dense"][name].shape
        wshapes = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
            lambda: jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg)))
        gshapes = jax.tree.map(tuple, transformer.param_shapes(
            port_config(jcfg)), is_leaf=lambda x: isinstance(x, torch.Size))
        assert gshapes == wshapes
        assert serve_supported(cfg) == jax_family(jcfg).serve_supported(
            jcfg)
        ok, why = serve_supported(cfg)
        assert ok and "full KV cache" in why
        assert transformer.slot_cache_layout(cfg) == "full"
        return
    if "mla" in kw:
        jcfg = jax_get_config("gpt-micro").replace(
            name="x", rope="none", learned_pos=16, **kw)
        want = jax_family(jcfg).init_cache(jcfg, 2, 20)
        got = transformer.init_cache(port_config(jcfg), 2, 20)
        assert set(got) == set(want) == {"dense"}
        assert set(got["dense"]) == set(want["dense"]) == {"ckv", "kr"}
        for name in ("ckv", "kr"):
            assert got["dense"][name].shape == want["dense"][name].shape
        assert serve_supported(cfg) == jax_family(jcfg).serve_supported(
            jcfg)
        ok, why = serve_supported(cfg)
        if "window" in kw:
            assert not ok and "no ring-buffer window layout" in why
            assert transformer.slot_cache_layout(cfg) == "unsupported"
        else:
            assert ok and "full MLA latent cache" in why
            assert transformer.slot_cache_layout(cfg) == "full-mla"
        return
    if "moe" in kw:
        jcfg = jax_get_config("gpt-micro").replace(
            name="x", rope="none", learned_pos=16, **kw)
        want = jax_family(jcfg).init_cache(jcfg, 2, 20)
        got = transformer.init_cache(port_config(jcfg), 2, 20)
        assert set(got) == set(want) == {"moe"}
        for name in ("k", "v"):
            assert got["moe"][name].shape == want["moe"][name].shape
        ok, why = serve_supported(cfg)
        assert ok and "full KV cache" in why
        assert transformer.slot_cache_layout(cfg) == "full"
        return
    if "window" in kw:
        jcfg = jax_get_config("gpt-micro").replace(
            name="x", rope="none", learned_pos=16, **kw)
        for max_len in (8, 20):
            want = jax_family(jcfg).init_cache(jcfg, 1, max_len)
            got = transformer.init_cache(port_config(jcfg), 1, max_len)
            assert got["dense"]["k"].shape == want["dense"]["k"].shape
        ok, why = serve_supported(cfg)
        assert ok and "ring-buffer window" in why
        assert transformer.slot_cache_layout(cfg) == "ring"
        return
    raise AssertionError(f"no case checks {what}")
