"""Rotary position embeddings: standard, partial-fraction, and M-RoPE.

The transformer family's ``rope="standard"`` configs (qwen, stablelm,
yi) and griffin's local attention rotate q and k with ``rope_tables``;
``rope="mrope"`` (qwen2-vl) with ``mrope_tables``.  M-RoPE (Qwen2-VL,
arXiv:2409.12191) splits the head's half-dim frequencies into (temporal,
height, width) sections, each turned by its own position stream.  With
three equal streams it is 1-D RoPE exactly.
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


def mrope_tables(positions3, hd, *, theta=10000.0, sections=(16, 24, 24),
                 dtype=torch.float32):
    """The rotation of ``apply_mrope`` for (3, B, S) ``positions3`` (the
    t, h and w streams) over heads of width ``hd``: (cos, sin) of shape
    (B, S, 1, hd/2) in ``dtype``, as ``rope_tables`` gives.  ``sections``
    are half-dim section sizes (sum == hd // 2): section i takes its
    angles from stream i."""
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, device=positions3.device)  # (hd/2,)
    ang_all = positions3.float()[..., None] * freqs  # (3, B, S, hd/2)
    ang = torch.cat([part[i] for i, part in enumerate(
        ang_all.split(list(sections), dim=-1))], dim=-1)  # (B, S, hd/2)
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


def apply_mrope(x, positions3, *, theta=10000.0, sections=(16, 24, 24)):
    """x: (B, S, H, hd); positions3: (3, B, S) int -- the (t, h, w)
    position streams, Qwen2-VL's layout."""
    return rotate(x, mrope_tables(positions3, x.shape[-1], theta=theta,
                                  sections=sections, dtype=x.dtype))
