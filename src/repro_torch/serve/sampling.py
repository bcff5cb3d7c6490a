"""Sampling for the serving macro loop and speculative rejection sampling.

The reference draws with JAX's threefry PRNG; this module carries the same
generator as integer torch ops, so a request's keys, random bits and
uniforms are bit-equal to the reference's on any device:

  * threefry2x32 -- the 20-round counter hash.  Torch has no unsigned
    32-bit arithmetic (``+``, ``<<`` and ``>>`` on ``torch.uint32`` are
    unimplemented), so words travel as int64 tensors holding uint32 values
    and every add or left shift is masked back to 32 bits;
  * a key is a ``(..., 2)`` int64 tensor of two such words.  ``prng_key``,
    ``fold_in``, ``split``, ``random_bits``, ``uniform``, ``gumbel`` and
    ``categorical`` follow ``jax.random`` with partitionable threefry
    (counter ``i`` of a draw is the pair ``(i >> 32, i & 0xFFFFFFFF)``),
    batched over the key's leading axes where JAX would ``vmap``;
  * ``SamplingParams`` -- temperature / top-k / top-p / seed;
    ``temperature == 0`` is greedy (argmax) and uses no randomness;
  * per-slot chains -- every request gets its own key
    (``request_key(seed, uid)``); ``next_keys`` advances all chains in
    lockstep, and the engine keeps the advanced key only for rows that
    really sampled, so a request's tokens depend on (seed, uid, prompt)
    alone, not on slot placement or interleaving;
  * ``filtered_probs`` -- temperature -> top-k -> top-p, renormalized;
  * ``residual_probs`` -- the leftover distribution ``max(p - q, 0)`` a
    rejected draft token is redrawn from.

The floating-point steps after the uniforms (log, softmax, cumsum) differ
from XLA's in the last bits, so a token can differ from the reference's
only where two perturbed scores nearly tie.
"""
from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30
M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = 1.1754943508222875e-38  # np.finfo(np.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decode-time sampling policy.  ``temperature == 0`` means greedy."""
    temperature: float = 0.0
    top_k: int = 0  # 0: no top-k cut
    top_p: float = 1.0  # 1.0: no nucleus cut
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 "
                             f"(got {self.temperature})")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {self.top_k})")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {self.top_p})")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def is_greedy(sp) -> bool:
    return sp is None or sp.greedy


# ------------------------------------------------------------------ threefry
def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, hi, lo):
    """Threefry-2x32 of the counter pair (hi, lo) under the key (k1, k2):
    two int64 tensors (or ints) of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (hi + ks[0]) & M32
    x1 = (lo + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a ``(..., 2)`` key batch; ``data`` is an
    int or an int tensor broadcasting against the key's leading axes (an
    int stays a kernel argument: no host-to-device copy)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([b1, b2], -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, lo)
    return torch.stack([b1, b2], -1)


def request_key(seed: int, uid) -> torch.Tensor:
    """Root of a request's sampling chain: ``fold_in(PRNGKey(seed), uid)``,
    a pure function of (seed, uid).  ``uid`` is an int or an int tensor
    (one key per entry, made where the tensor lives)."""
    data = torch.as_tensor(uid, dtype=torch.int64) & M32
    b1, b2 = threefry2x32(0, int(seed) & M32, 0, data)
    return torch.stack([b1, b2], -1)


def next_keys(keys: torch.Tensor):
    """Advance a (B, 2) batch of per-slot chains one step.

    Returns (carry_keys, sample_keys): the carry continues each chain, the
    sample key is consumed by this step's draw.  The caller keeps the carry
    only for rows that really sampled, so a chain's position always equals
    the row's generated-token count."""
    s = split(keys)
    return s[..., 0, :], s[..., 1, :]


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, ``(*key.shape[:-1], *shape)`` int64:
    ``b1 ^ b2`` of threefry over the flat element index."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    b1, b2 = threefry2x32(k1, k2, count.reshape(shape) >> 32,
                          count.reshape(shape) & M32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval): the top 23 random bits as the
    mantissa of a float in [1, 2), minus 1, scaled, then floored at
    ``minval`` (``jax.random.uniform``)."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    f32 = dict(dtype=torch.float32, device=key.device)
    lo = torch.full((), minval, **f32)
    hi = torch.full((), maxval, **f32)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel noise, f32 (``jax.random.gumbel``, mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per distribution over the last axis: the Gumbel-max trick
    with the noise drawn over ``logits.shape[len(lead):]`` for each key of
    the ``lead = key.shape[:-1]`` batch (``vmap`` of
    ``jax.random.categorical``)."""
    lead = key.dim() - 1
    g = gumbel(key, logits.shape[lead:])
    return torch.argmax(g + logits, dim=-1)


# ------------------------------------------------------------------ filters
def filtered_probs(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """(B, V) sampling distribution: temperature -> top-k -> top-p.

    Filtering masks to ``NEG_INF`` and renormalizes, so every consumer
    (the categorical draw, speculative accept ratios, residual
    distributions) sees the same support."""
    lg = logits.float()
    lg = lg / torch.full((), max(sp.temperature, 1e-6), dtype=torch.float32,
                         device=lg.device)
    V = lg.shape[-1]
    if sp.top_k and sp.top_k < V:
        kth = torch.topk(lg, sp.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg >= kth, lg, NEG_INF)
    if sp.top_p < 1.0:
        probs = torch.softmax(lg, dim=-1)
        order = torch.argsort(-lg, dim=-1, stable=True)
        sorted_probs = probs.gather(-1, order)
        exclusive = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
        keep_sorted = exclusive < sp.top_p  # always keeps the top token
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        lg = torch.where(keep, lg, NEG_INF)
    return torch.softmax(lg, dim=-1)


def sample_probs(probs: torch.Tensor, sample_keys: torch.Tensor):
    """Categorical draw per row. probs: (B, V); sample_keys: (B, 2)."""
    logp = torch.log(probs.clamp_min(1e-38))
    logp = torch.where(probs > 0, logp, NEG_INF)
    return categorical(sample_keys, logp).to(torch.int32)


def sample_logits(logits: torch.Tensor, sample_keys: torch.Tensor,
                  sp: SamplingParams):
    """One sampled token per row under ``sp`` (greedy is argmax and
    consumes no randomness)."""
    if is_greedy(sp):
        return logits.argmax(-1).to(torch.int32)
    return sample_probs(filtered_probs(logits, sp), sample_keys)


def residual_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Leftover distribution for speculative rejection sampling.

    A draft token ``x ~ q`` is accepted with probability
    ``min(1, p(x) / q(x))``; on rejection the replacement is drawn from
    ``normalize(max(p - q, 0))``, whose mixture with the accepted draws is
    exactly ``p``.  Degenerate rows (``p <= q`` everywhere, possible only
    up to float error when p == q) fall back to ``p``."""
    r = (p - q).clamp_min(0.0)
    s = r.sum(-1, keepdim=True)
    return torch.where(s > 0, r / s.clamp_min(1e-38), p)
