"""Shared helpers for the port's parity tests (``test_torch_*.py``).

Inputs are made from seeded numpy and handed to both packages; params are
initialised by the JAX package (or drawn from numpy) and converted leaf for
leaf, so both sides compute on identical weights.  Sampled tokens compare
under the near-tie rule of ``check_sampled``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import get_family as jax_family
from repro_torch.configs.base import ModelConfig as TorchConfig
from repro_torch.convert import from_jax

F32_ATOL = 2e-5  # f32: the frameworks sum in different orders

# One intra-op thread per test process: the suite runs in several worker
# processes at once, and PyTorch's default of one thread per core
# oversubscribes the CPU many times over (small ops then wait on spinning
# threads).
torch.set_num_threads(1)


def port_config(jcfg):
    """The port's twin of a JAX ``ModelConfig`` (the TPU-only knobs of the
    JAX config have no counterpart and are dropped)."""
    names = {f.name for f in dataclasses.fields(TorchConfig)}
    return TorchConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})


def tiny_gqa(**kw):
    """Tiny GQA decoder with learned positions (4 query heads over 2 KV
    heads), as a JAX config."""
    base = dict(name="tiny-gqa", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=101, rope="none",
                learned_pos=64, norm="ln", act="gelu", max_seq_len=64)
    base.update(kw)
    return JaxConfig(**base)


def jax_params(jcfg, seed=0, randomize=False):
    """JAX-initialised params as numpy; ``randomize`` redraws every leaf
    from numpy (so zero-initialised biases and unit norms are exercised
    too)."""
    p = jax.tree.map(np.asarray,
                     jax_family(jcfg).init(jax.random.PRNGKey(seed), jcfg))
    if randomize:
        rng = np.random.default_rng(seed)

        def redraw(a):
            return (0.05 * rng.standard_normal(a.shape)).astype(a.dtype)

        p = jax.tree.map(redraw, p)
        for grp in (p["dense_blocks"]["ln1"], p["dense_blocks"]["ln2"],
                    p["final_norm"]):
            grp["scale"] = grp["scale"] + np.float32(1.0)
    return p


def redrawn_params(jcfg, seed=0):
    """JAX-initialised params redrawn from seeded numpy: the embedding
    and an untied head at std 0.02, every other matrix and bias at std
    0.2, norm scales at 1 +- 0.1 (at JAX's init greedy decoding repeats
    the last token, which would hide a fault in the positions; a small
    head keeps f32 logits below 1, where 2e-5 is summation-order noise);
    returns (numpy tree for JAX, tensors for the port)."""
    init = jax.jit(lambda key: jax_family(jcfg).init(key, jcfg))
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or name.endswith("_norm']"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        std = 0.02 if "embed" in name or "'head'" in name else 0.2
        return (std * rng.standard_normal(a.shape)).astype(a.dtype)

    p = jax.tree_util.tree_map_with_path(redraw, p)
    return p, from_jax(p)


def both_params(jcfg, **kw):
    """(numpy params for JAX, the same as CPU tensors for the port)."""
    p = jax_params(jcfg, **kw)
    return p, from_jax(p)


def reference_example(name):
    """``examples/<name>.py`` of the JAX package, loaded by path (the
    examples are no package); ``train_100m`` registers its configs in the
    JAX registry as it loads."""
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------- sampling
NEAR_TIE = 1e-4  # top-2 gap of perturbed scores below which routes may differ


def perturbed_scores(logits, key, sp):
    """(B, V) Gumbel-perturbed log-probabilities of the port's sampled draw
    (``sampling.sample_logits``): the drawn token is their argmax."""
    from repro_torch.serve import sampling

    probs = sampling.filtered_probs(logits, sp)
    logp = torch.where(probs > 0, torch.log(probs.clamp_min(1e-38)),
                       sampling.NEG_INF)
    return sampling.gumbel(key, logits.shape[-1:]) + logp


def top2_gap(scores):
    top = scores.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).numpy()


def sampled_replay(cfg, params, prompt, uid, sp, tokens, max_len):
    """Sequential replay of one request's sampling chain in the port (its
    scalar ``prefill`` and ``decode_step``), fed ``tokens`` as the
    generated prefix: returns (drawn, gaps), where ``drawn[i]`` is the
    token the chain draws at step i after ``tokens[:i]`` and ``gaps[i]``
    the top-2 gap of the perturbed scores there.  Fed the chain's own
    draws, ``drawn`` is the engine's expected output."""
    from repro_torch.models import get_family
    from repro_torch.serve import sampling

    fam = get_family(cfg)
    cache = fam.init_cache(cfg, 1, max_len)
    x = torch.from_numpy(np.asarray(prompt, np.int32))[None]
    logits, cache = fam.prefill(params, {"tokens": x}, cfg, cache)
    keys = sampling.request_key(sp.seed, torch.tensor([uid]))
    drawn, gaps = [], []
    pos = len(prompt)
    for i, t in enumerate(tokens):
        keys, subs = sampling.next_keys(keys)
        scores = perturbed_scores(logits, subs, sp)
        drawn.append(int(scores.argmax(-1)[0]))
        gaps.append(float(top2_gap(scores)[0]))
        if i + 1 < len(tokens):
            logits, cache = fam.decode_step(
                params, torch.tensor([int(t)], dtype=torch.int32), pos,
                cache, cfg)
            pos += 1
    return np.asarray(drawn, np.int32), np.asarray(gaps)


def check_sampled(what, uid, got, want, gaps):
    """Sampled tokens must be equal, except at a near tie: at the first
    mismatch the top-2 gap of the perturbed scores there (``gaps``, along
    the common prefix) must be below ``NEAR_TIE``; the mismatch is printed
    and the rest of the request is not compared.  Returns the near tie
    (uid, step, gap) or None."""
    got, want = np.asarray(got), np.asarray(want)
    n = min(len(got), len(want))
    diff = np.nonzero(got[:n] != want[:n])[0]
    if diff.size == 0:
        assert len(got) == len(want), f"uid {uid}: {what} lengths differ"
        return None
    t = int(diff[0])
    gap = float(gaps[t])
    assert gap < NEAR_TIE, (f"uid {uid}: {what} differ at step {t}, where "
                            f"the top-2 perturbed-score gap is {gap:.3g}")
    print(f"near tie: uid {uid} {what} differ at step {t} (gap {gap:.3g})")
    return uid, t, gap


# --------------------------------------------------------------- bf16 check
def bf16_logit_errors(jcfg, params, prompts, n_steps=8):
    """How far each package's bf16 route lies from the f32 route, on the
    same bf16-cast weights (ROADMAP 1.3).

    ``params``: the JAX family's numpy tree for ``jcfg``; ``prompts``: (B,
    P) int32.  The weights are cast to bf16 once; the f32 route runs them
    upcast.  Tokens: JAX's f32 greedy route (prefill, then ``n_steps - 1``
    decode steps).  Reference: JAX's f32 full forward over the prompt and
    those tokens.  Each bf16 route runs ``prefill`` and ``n_steps`` decode
    steps fed the same tokens, in its own package with the config at
    ``bfloat16`` params and compute.  Returns (port error, JAX error,
    max |reference logit|), the errors the max |logit| difference over the
    ``n_steps`` decode steps."""
    import jax.numpy as jnp

    from repro_torch.models import get_family

    jfam = jax_family(jcfg)
    jcfg32 = jcfg.replace(param_dtype="float32", compute_dtype="float32")
    jcfg16 = jcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    p16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                       params)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), p16)
    B, P = prompts.shape
    max_len = P + n_steps + 1

    def jax_route(cfg, p):
        prefill = jax.jit(lambda p_, t, c: jfam.prefill(p_, {"tokens": t},
                                                        cfg, c))
        decode = jax.jit(lambda p_, t, pos, c: jfam.decode_step(
            p_, t, pos, c, cfg))
        return prefill, decode

    prefill32, decode32 = jax_route(jcfg32, p32)
    cache = jfam.init_cache(jcfg32, B, max_len)
    logits, cache = prefill32(p32, jnp.asarray(prompts), cache)
    fed = []
    for i in range(n_steps):
        fed.append(np.asarray(logits).argmax(-1).astype(np.int32))
        logits, cache = decode32(p32, jnp.asarray(fed[-1]), P + i, cache)
    fed = np.stack(fed, 1)  # (B, n_steps): the decode steps' inputs
    full = np.concatenate([prompts, fed], 1)
    ref = np.asarray(jfam.forward(p32, {"tokens": jnp.asarray(full)},
                                  jcfg32)[0], np.float32)[:, P:]

    prefill16, decode16 = jax_route(jcfg16, p16)
    cache = jfam.init_cache(jcfg16, B, max_len)
    _, cache = prefill16(p16, jnp.asarray(prompts), cache)
    got_jax = []
    for i in range(n_steps):
        logits, cache = decode16(p16, jnp.asarray(fed[:, i]), P + i, cache)
        got_jax.append(np.asarray(logits, np.float32))

    cfg16 = port_config(jcfg16)
    fam = get_family(cfg16)
    tp16 = from_jax(p16)
    with torch.no_grad():
        tcache = fam.init_cache(cfg16, B, max_len)
        _, tcache = fam.prefill(tp16, {"tokens": torch.from_numpy(prompts)},
                                cfg16, tcache)
        got_port = []
        for i in range(n_steps):
            logits, tcache = fam.decode_step(
                tp16, torch.from_numpy(fed[:, i].copy()), P + i, tcache,
                cfg16)
            got_port.append(logits.float().numpy())
    port_err = float(np.abs(np.stack(got_port, 1) - ref).max())
    jax_err = float(np.abs(np.stack(got_jax, 1) - ref).max())
    return port_err, jax_err, float(np.abs(ref).max())
