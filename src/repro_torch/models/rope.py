"""Rotary position embeddings, standard and partial-fraction.

Griffin's local attention rotates q and k with it; the transformer
family's RoPE configs come with their own slice (ROADMAP.md), and so does
multimodal RoPE.
"""
from __future__ import annotations

import torch


def rope_freqs(dim, theta=10000.0, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def _rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, *, theta=10000.0, fraction=1.0):
    """x: (B, S, H, hd); positions: (B, S) int.

    ``fraction`` < 1 rotates only the first ``fraction * hd`` dims
    (partial rotary); angles are computed in float32 and cast to x's
    dtype, as in the reference package.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, device=x.device)  # (rot/2,)
    ang = positions.float()[..., None] * freqs  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    xr = _rotate(xr, cos, sin)
    return torch.cat([xr, xp], dim=-1) if rot < hd else xr
