"""Shared building blocks: inits, norms, activation, cache-length quantum.

Params are nested dicts of tensors, stacked over the layer axis (leading
``L``) exactly as in the reference package, so converted weights line up
leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def trunc_normal(gen: torch.Generator, shape, std=0.02, dtype=torch.float32,
                 device=None):
    """``std`` times a standard normal truncated to [-2, 2], drawn on
    ``device`` (default: the generator's; on ``meta`` nothing is drawn)."""
    t = torch.empty(shape, dtype=torch.float32, device=device or gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    """``x / sqrt(mean(x^2) + eps) * scale`` with float32 statistics."""
    return F.rms_norm(x.float(), (x.shape[-1],), scale.float(),
                      eps).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """``(x - mean) / sqrt(var + eps) * scale + bias`` (biased variance)
    with float32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                        None if bias is None else bias.float(),
                        eps).to(x.dtype)


def apply_norm(x, p, kind, eps=1e-6):
    # eps 1e-6 for LayerNorm too, as the reference package does
    if kind == "rms":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p.get("bias"), eps)


def init_norm(kind, dim, layers=None, dtype=torch.float32, device="cpu"):
    shape = (dim,) if layers is None else (layers, dim)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def gelu(x):
    return F.gelu(x, approximate="tanh")


def pad_cache_len(n: int) -> int:
    """Slot-pool cache length for ``max_len`` positions: above 256 rounds
    up to a multiple of 64, otherwise to a multiple of 8.  Kept from the
    reference package's pool layout so both packages allocate the same
    shapes; the padded tail is masked by each row's ``kv_len``."""
    q = 8 if n <= 256 else 64
    return -(-n // q) * q


def take_layer(stacked, i):
    """Layer ``i`` of every leaf of a stacked-params subtree (views)."""
    return {k: take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def slice_layers(stacked, start, stop):
    """Layers ``start:stop`` of every leaf of a stacked subtree (views)."""
    return {k: slice_layers(v, start, stop) if isinstance(v, dict)
            else v[start:stop] for k, v in stacked.items()}


def freeze_rows(old, new, done):
    """Per-row freeze for the continuous-batching slot protocol: rows
    flagged in ``done`` (B,) keep ``old``'s values, the rest take
    ``new``'s.  ``old``/``new`` are matching trees whose leaves lead with
    the batch (slot) axis.  A ``torch.where`` on the flag: no host sync,
    and a frozen row's bytes stay bit for bit (a recurrent update is
    irreversible, unlike a KV write that can store the same bytes again).
    """
    if isinstance(new, dict):
        return {k: freeze_rows(old[k], v, done) for k, v in new.items()}
    return torch.where(done.reshape(done.shape + (1,) * (new.dim() - 1)),
                       old, new)
