"""Feed-forward blocks: GELU MLP, SwiGLU / GeGLU gated MLPs."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import gelu, trunc_normal


def mlp(x, p, act="swiglu"):
    """x: (B,S,D). p has w_up (D,F) [+ w_gate (D,F)], w_down (F,D) and
    optional biases."""
    h = x @ p["w_up"].to(x.dtype)
    if "b_up" in p:
        h = h + p["b_up"].to(x.dtype)
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(x.dtype)
        if "b_gate" in p:
            g = g + p["b_gate"].to(x.dtype)
        g = F.silu(g) if act == "swiglu" else gelu(g)
        h = g * h
    else:
        h = gelu(h)
    y = h @ p["w_down"].to(x.dtype)
    if "b_down" in p:
        y = y + p["b_down"].to(x.dtype)
    return y


def init_mlp(gen, d_model, d_ff, *, layers=None, act="swiglu", bias=False,
             dtype=torch.float32, std=0.02, device=None):
    device = device or gen.device

    def shp(*s):
        return s if layers is None else (layers, *s)

    p = {
        "w_up": trunc_normal(gen, shp(d_model, d_ff), std, dtype, device),
        "w_down": trunc_normal(gen, shp(d_ff, d_model), std, dtype, device),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = trunc_normal(gen, shp(d_model, d_ff), std, dtype,
                                   device)
    if bias:
        zeros = dict(dtype=dtype, device=device)
        p["b_up"] = torch.zeros(shp(d_ff), **zeros)
        p["b_down"] = torch.zeros(shp(d_model), **zeros)
        if act in ("swiglu", "geglu"):
            p["b_gate"] = torch.zeros(shp(d_ff), **zeros)
    return p
