"""Deterministic synthetic LM tokens with learnable structure (numpy).

Tokens follow a noisy affine-modular chain
    t_{k+1} = (a * t_k + b + e_k) mod V,   e_k ~ clipped geometric,
so a model can fit them.  Output is byte-identical to the reference
package's ``lm_batch``: batch content is a pure function of
(seed, step, shard).
"""
from __future__ import annotations

import numpy as np

_A, _B = 5, 17


def _rng(seed, step, shard=0):
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def lm_batch(vocab_size, batch, seq_len, *, seed=0, step=0, shard=0,
             noise=4):
    """(batch, seq_len) int32 tokens with learnable chain structure."""
    r = _rng(seed, step, shard)
    t0 = r.integers(0, vocab_size, size=(batch, 1))
    e = r.geometric(0.5, size=(batch, seq_len - 1)).clip(0, noise)
    toks = [t0]
    cur = t0
    for k in range(seq_len - 1):
        cur = (_A * cur + _B + e[:, k:k + 1]) % vocab_size
        toks.append(cur)
    return np.concatenate(toks, axis=1).astype(np.int32)


def lm_data_iter(vocab_size, batch, seq_len, *, seed=0, shard=0,
                 start_step=0):
    step = start_step
    while True:
        yield {"tokens": lm_batch(vocab_size, batch, seq_len, seed=seed,
                                  step=step, shard=shard)}
        step += 1
