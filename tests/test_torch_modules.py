"""The port's small modules against their JAX counterparts on the CPU:
configs, synthetic data, norms, activation, MLP, plain attention, and the
parameter conversion.  Inputs come from seeded numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, port_config, reference_example
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import ffn as jax_ffn
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import from_jax, to_numpy
from repro_torch.data import lm_batch
from repro_torch.models import attention, common, ffn


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_configs_match_the_reference_registry():
    """Every config the port registers equals its JAX twin field for field
    (the JAX TPU-only knobs aside), the two the 100M example registers
    too."""
    import repro_torch.examples.train_100m  # noqa: F401  (registers them)
    reference_example("train_100m")  # registers the JAX twins
    names = list_configs()
    assert {"gpt-base", "gpt-small", "gpt-micro", "gpt-micro-big",
            "bert-base", "deit-micro", "gpt-100m", "gpt-25m"} <= set(names)
    for name in names:
        assert get_config(name) == port_config(jax_get_config(name)), name
    cfg = get_config("gpt-base")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.learned_pos) == (12, 768, 12, 64, 3072,
                                                 50257, 1024)


@pytest.mark.parametrize("seed,batch,seq", [(0, 4, 17), (7, 1, 600)])
def test_lm_batch_byte_identical(seed, batch, seq):
    a = lm_batch(997, batch, seq, seed=seed, step=3)
    b = jax_lm_batch(997, batch, seq, seed=seed, step=3)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_norms_match(kind):
    """LayerNorm gets eps 1e-6 through ``apply_norm`` too; the fused
    PyTorch norms match the reference's written-out formulas."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 48, scale=3.0) + 1.5
    p = {"scale": _rand(rng, 48) + 1.0}
    if kind == "ln":
        p["bias"] = _rand(rng, 48)
    want = np.asarray(jax_common.apply_norm(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), kind))
    tp = from_jax(p)
    got = common.apply_norm(torch.from_numpy(x), tp, kind)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    if kind == "ln":  # the module-level default eps stays 1e-5
        want = jax_common.layer_norm(jnp.asarray(x), jnp.asarray(p["scale"]),
                                     jnp.asarray(p["bias"]))
        got = common.layer_norm(torch.from_numpy(x), tp["scale"], tp["bias"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 241, dtype=np.float32)
    np.testing.assert_allclose(common.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_common.gelu(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("act,bias", [("gelu", False), ("swiglu", True),
                                      ("geglu", False)])
def test_mlp_matches(act, bias):
    rng = np.random.default_rng(2)
    p = {"w_up": _rand(rng, 32, 64, scale=0.2),
         "w_down": _rand(rng, 64, 32, scale=0.2)}
    if act != "gelu":
        p["w_gate"] = _rand(rng, 32, 64, scale=0.2)
    if bias:
        p.update(b_up=_rand(rng, 64), b_down=_rand(rng, 32),
                 b_gate=_rand(rng, 64))
    x = _rand(rng, 2, 3, 32)
    want = jax_ffn.mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, p), act)
    got = ffn.mlp(torch.from_numpy(x), from_jax(p), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("case", ["causal", "offset_kv_len", "per_row",
                                  "chunked", "noncausal"])
def test_plain_attention_matches(case):
    """The plain route, including per-row kv_len with a 0 row (exact
    zeros) and query chunking."""
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, KV, hd = 3, 12, 20, 4, 2, 8
    kw, Sq = {
        "causal": (dict(causal=True), Sk),
        "offset_kv_len": (dict(causal=True, q_offset=5, kv_len=17), Sq),
        "per_row": (dict(causal=False, kv_len=np.array([0, 7, 20])), 1),
        "chunked": (dict(causal=True, chunk_q=8), Sk),
        "noncausal": (dict(causal=False), Sk),
    }[case]
    q = _rand(rng, B, Sq, H, hd)
    k, v = _rand(rng, B, Sk, KV, hd), _rand(rng, B, Sk, KV, hd)
    jkw = dict(kw)
    tkw = dict(kw)
    if isinstance(kw.get("kv_len"), np.ndarray):
        jkw["kv_len"] = jnp.asarray(kw["kv_len"], jnp.int32)
        tkw["kv_len"] = torch.from_numpy(kw["kv_len"].astype(np.int32))
    want = jax_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **jkw)
    got = attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    if case == "per_row":
        assert (got[0] == 0).all()


@pytest.mark.parametrize("n", [1, 7, 8, 48, 255, 256, 257, 1000, 1024])
def test_pad_cache_len_matches(n):
    assert common.pad_cache_len(n) == jax_common.pad_cache_len(n)


def test_trunc_normal_is_seeded_and_truncated():
    gen = torch.Generator().manual_seed(5)
    a = common.trunc_normal(gen, (4000,), std=0.02)
    b = common.trunc_normal(torch.Generator().manual_seed(5), (4000,),
                            std=0.02)
    assert torch.equal(a, b)
    assert a.abs().max() <= 0.04 and 0.015 < float(a.std()) < 0.02


def test_convert_round_trip():
    rng = np.random.default_rng(4)
    tree = {"a": _rand(rng, 3, 2), "g": {"b": np.arange(5, dtype=np.int32)}}
    back = to_numpy(from_jax(tree))
    assert back.keys() == tree.keys()
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["g"]["b"], tree["g"]["b"])


def test_port_config_drops_only_tpu_knobs():
    jax_fields = {f.name for f in dataclasses.fields(
        jax_get_config("gpt-base"))}
    port_fields = {f.name for f in dataclasses.fields(get_config("gpt-base"))}
    assert jax_fields - port_fields == {
        "decode_kernel", "remat", "attn_logits_dtype", "attn_prefix_chunks",
        "unroll_scans"}
    assert port_fields <= jax_fields
