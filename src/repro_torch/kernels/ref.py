"""Plain PyTorch versions of the kernels (the allclose targets).

``ops`` routes CPU tensors here; ``chip_smoke.py`` holds each CUDA kernel
against these on the card.  All math runs in float32 and the result is cast
back to the input dtype, as in the reference package's oracles.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd)."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def slot_decode_attention_ref(q, k, v, kv_len):
    """q: (B, H, hd); k, v: (B, S, KV, hd) -- the slot pool's layout;
    kv_len: (B,) valid lengths -> (B, H, hd).  Rows with kv_len == 0 (idle
    or finished slots) return exact zeros."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * hd ** -0.5
    kvl = kv_len.reshape(-1).to(torch.int64).expand(B)
    mask = torch.arange(S, device=q.device)[None] < kvl[:, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    out = out * (kvl > 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, H, hd).to(q.dtype)


def tr_sandwich_ref(x, a_i, a_o):
    """x: (N, D1i, D1o); a_i: (D1i, D2i); a_o: (D1o, D2o) ->
    Y[n] = a_i^T @ x[n] @ a_o, (N, D2i, D2o) in x's dtype (f32 math)."""
    y = torch.einsum("nio,ij,om->njm", x.float(), a_i.float(), a_o.float())
    return y.to(x.dtype)
