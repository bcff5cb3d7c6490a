"""Deterministic synthetic data with learnable structure (numpy).

  * LM tokens follow a noisy affine-modular chain
        t_{k+1} = (a * t_k + b + e_k) mod V,   e_k ~ clipped geometric,
    so a model can fit them.
  * Vision batches plant a class-dependent low-frequency pattern in noise.
  * Audio-frame batches plant a unit sequence into continuous frames.

Output is byte-identical to the reference package's: batch content is a
pure function of (seed, step, shard).
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


def vision_batch(n_classes, batch, image_size, patch_size, *, seed=0,
                 step=0, shard=0, channels=3):
    """Patchified synthetic images: returns {"inputs": (B, N, P), "labels"}.

    Class c plants cos/sin gratings of frequency (c mod 8), a pattern a
    ViT can learn to classify.
    """
    r = _rng(seed, step, shard)
    labels = r.integers(0, n_classes, size=(batch,))
    H = image_size
    yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    imgs = 0.3 * r.standard_normal((batch, H, H, channels)).astype(np.float32)
    freq = (labels % 8 + 1).astype(np.float32)
    phase = (labels // 8).astype(np.float32)
    pat = np.cos(2 * np.pi * freq[:, None, None] * xx[None] / H
                 + phase[:, None, None]) \
        * np.sin(2 * np.pi * freq[:, None, None] * yy[None] / H)
    imgs += pat[..., None].astype(np.float32)
    # patchify -> (B, N, p*p*C)
    p = patch_size
    n = H // p
    x = imgs.reshape(batch, n, p, n, p, channels).transpose(0, 1, 3, 2, 4, 5)
    x = x.reshape(batch, n * n, p * p * channels)
    return {"inputs": x, "labels": labels.astype(np.int32)}


def frames_batch(dim, vocab_size, batch, seq_len, *, seed=0, step=0,
                 shard=0):
    """Continuous frames + per-frame unit labels (HuBERT-style stub).

    Frame t embeds its unit id as a planted sinusoid so the encoder can
    learn the masked-unit task.
    """
    r = _rng(seed, step, shard)
    units = lm_batch(vocab_size, batch, seq_len, seed=seed + 1, step=step,
                     shard=shard)
    base = r.standard_normal((batch, seq_len, dim)).astype(np.float32) * 0.3
    t = np.arange(dim)[None, None, :]
    base += np.sin(2 * np.pi * (units[..., None] + 1) * t / dim).astype(
        np.float32)
    return {"inputs": base, "tokens": units}
