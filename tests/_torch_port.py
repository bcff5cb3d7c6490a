"""Shared helpers for the port's parity tests (``test_torch_*.py``).

Inputs are made from seeded numpy and handed to both packages; params are
initialised by the JAX package (or drawn from numpy) and converted leaf for
leaf, so both sides compute on identical weights.
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
