"""Rotary position embeddings, standard and partial-fraction.

The transformer family's ``rope="standard"`` configs (qwen, stablelm,
yi) and griffin's local attention rotate q and k with it.  Multimodal
RoPE (``"mrope"``, qwen2-vl) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch


def rope_freqs(dim, theta=10000.0, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def _rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_tables(positions, hd, *, theta=10000.0, fraction=1.0,
                dtype=torch.float32):
    """The rotation of ``apply_rope`` for (B, S) ``positions`` over heads
    of width ``hd``: (cos, sin) of shape (B, S, 1, rot/2) in ``dtype``,
    with ``rot`` the rotated width.  A model rotates q and k of every
    layer with one table."""
    rot = int(hd * fraction)
    rot -= rot % 2
    freqs = rope_freqs(rot, theta, device=positions.device)  # (rot/2,)
    ang = positions.float()[..., None] * freqs  # (B, S, rot/2)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def rotate(x, tables):
    """x: (B, S, H, hd) rotated by ``rope_tables``' (cos, sin): the first
    ``rot`` dims turn, the rest pass through."""
    cos, sin = tables
    rot = 2 * cos.shape[-1]
    xr = _rotate(x[..., :rot], cos, sin)
    return torch.cat([xr, x[..., rot:]], dim=-1) if rot < x.shape[-1] else xr


def apply_rope(x, positions, *, theta=10000.0, fraction=1.0):
    """x: (B, S, H, hd); positions: (B, S) int.

    ``fraction`` < 1 rotates only the first ``fraction * hd`` dims
    (partial rotary); angles are computed in float32 and cast to x's
    dtype, as in the reference package.
    """
    return rotate(x, rope_tables(positions, x.shape[-1], theta=theta,
                                 fraction=fraction, dtype=x.dtype))
