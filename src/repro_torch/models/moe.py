"""Mixture-of-Experts with capacity dispatch (GShard/Switch semantics).

Token-choice top-k routing with per-group expert capacity, as in the
reference package: tokens are regrouped into dispatch groups of at most
``MOE_GROUP_SIZE``; inside a group each expert takes at most ``capacity =
max(int(sg * K / E * capacity_factor), 1)`` tokens, filled k-major (every
token's first choice before any token's second choice), then in token
order; choices past capacity are dropped (they contribute nothing and the
kept weights are not renormalised).

The reference realises dispatch and combine as one-hot einsums over a
(G, S_g, E, C) tensor.  Here the same positions drive an ``index_add`` of
each kept token into its (group, expert, slot) row and a gather of the
expert outputs back, with one batched product per expert weight over all
groups: every expert reads its weights once for all its ``G * C`` slots.
A slot receives exactly one token, so the dispatched rows equal the
einsum's bit for bit.

Supports softmax top-k (Switch / Mixtral / phi-3.5-MoE) and sigmoid
scoring with top-k renormalisation plus shared experts (DeepSeek-V3), the
Switch auxiliary load-balance loss and ``moe_dispatch_dtype`` rounding of
the combine weights.  The reference's ``moe_specs`` (sharding) is not
here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import trunc_normal

MOE_GROUP_SIZE = 512  # dispatch-group tokens: bounds capacity per group


def _topk(scores, k):
    """(values, indices) of the ``k`` largest entries of the last axis,
    ties broken towards the lower index as ``jax.lax.top_k`` breaks them
    (``torch.topk`` does not promise any order among equal scores).  The
    values carry gradient to ``scores``."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
    idx = order[..., :k]
    return scores.gather(-1, idx), idx


def router(x, w_router, *, top_k, score="softmax"):
    """x: (B, S, D) -> (weights (B, S, K) f32, idx (B, S, K) int64, aux f32).

    The router runs in f32 whatever ``x``'s dtype.  ``aux`` is the Switch
    load-balance loss ``E * sum_e f_e * p_e / K`` over the pre-capacity
    routed fractions ``f`` and the mean probabilities ``p``; gradient flows
    through the top-k weights and ``p``, not through ``f``.
    """
    logits = x.float() @ w_router.float()
    E = logits.shape[-1]
    if score == "softmax":
        probs = torch.softmax(logits, dim=-1)
        w, idx = _topk(probs, top_k)
    else:  # sigmoid scoring (DeepSeek-V3): renormalised over the top-k
        scores = torch.sigmoid(logits)
        w, idx = _topk(scores, top_k)
        probs = scores / scores.sum(-1, keepdim=True).clamp(min=1e-9)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    n_tok = idx.shape[0] * idx.shape[1]
    f = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device)) / n_tok
    p = probs.mean((0, 1))
    aux = E * torch.sum(f * p) / top_k
    return w, idx, aux


def expert_positions(idx, n_experts):
    """Each choice's position in its expert's queue: (B, S, K) int64.

    Priority is k-major, then token order (lower k first, then earlier
    tokens), counted per batch row (a row is one dispatch group)."""
    B, S, K = idx.shape
    onehot = F.one_hot(idx, n_experts).to(torch.int32)  # (B, S, K, E)
    flat = onehot.transpose(1, 2).reshape(B, K * S, n_experts)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = pos.reshape(B, K, S, n_experts).transpose(1, 2)
    return pos.gather(-1, idx[..., None])[..., 0].long()


def dispatch_combine(weights, idx, n_experts, capacity,
                     dtype=torch.float32):
    """The reference's dispatch (0/1) and combine tensors, (B, S, E, C) in
    ``dtype``: choice (s, k) that fits its expert's capacity sits at slot
    ``expert_positions`` of expert ``idx[s, k]``, carrying weight
    ``weights[s, k]`` in ``combine``.  ``moe_mlp`` uses the positions
    directly; this form is kept for callers and tests."""
    B, S, K = idx.shape
    pos = expert_positions(idx, n_experts)
    keep = pos < capacity
    # (expert, slot) column of each kept choice; drops write a zero into
    # the extra column E * C
    cols = torch.where(keep, idx * capacity + pos, n_experts * capacity)
    out = []
    for vals in (keep.float(), torch.where(keep, weights.float(), 0.0)):
        t = torch.zeros((B, S, n_experts * capacity + 1),
                        dtype=torch.float32, device=idx.device)
        t.scatter_(-1, cols, vals)
        out.append(t[..., :-1].reshape(B, S, n_experts, capacity).to(dtype))
    return tuple(out)


def group_capacity(sg, cfg):
    """Slots each expert has in a dispatch group of ``sg`` tokens."""
    return max(int(sg * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def moe_mlp(x, p, cfg):
    """Routed-experts MLP.  x: (B, S, D) -> (y (B, S, D), aux f32).

    p: w_router (D, E); w_up / w_gate (E, D, F), w_down (E, F, D);
    optional shared expert shared_w_up / shared_w_gate (D, Fs),
    shared_w_down (Fs, D).  Dispatch groups are ``sg = min(MOE_GROUP_SIZE,
    S)`` tokens of one row (1 when S == 1); an S above the group size must
    be a multiple of it, as in the reference.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    weights, idx, aux = router(x, p["w_router"], top_k=K,
                               score=cfg.router_score)
    sg = min(MOE_GROUP_SIZE, S) if S > 1 else 1
    assert S % sg == 0, (S, sg)
    G = B * (S // sg)
    capacity = group_capacity(sg, cfg)
    ig = idx.reshape(G, sg, K)
    pos = expert_positions(ig, E)
    keep = pos < capacity
    # flat (group, expert, slot) row of every kept choice; drops go to the
    # extra row G * E * C, which no expert reads and whose output is zero
    n_rows = G * E * capacity
    base = torch.arange(G, device=x.device)[:, None, None] * (E * capacity)
    rows = torch.where(keep, base + ig * capacity + pos, n_rows)
    src = x.reshape(G, sg, 1, D).expand(G, sg, K, D).reshape(-1, D)
    xe = x.new_zeros(n_rows + 1, D).index_add(0, rows.reshape(-1), src)
    xe = xe[:n_rows].reshape(G, E, capacity, D).transpose(0, 1).reshape(
        E, G * capacity, D)
    h = torch.bmm(xe, p["w_up"].to(x.dtype))
    g = torch.bmm(xe, p["w_gate"].to(x.dtype))
    ye = torch.bmm(F.silu(g) * h, p["w_down"].to(x.dtype))  # (E, G*C, D)
    ye = ye.reshape(E, G, capacity, D).transpose(0, 1).reshape(n_rows, D)
    ye = torch.cat([ye, ye.new_zeros(1, D)])
    # combine weights rounded to the dispatch dtype, then the compute dtype
    ddt = getattr(torch, cfg.moe_dispatch_dtype)
    wk = weights.reshape(G, sg, K).to(ddt).to(x.dtype)
    wk = torch.where(keep, wk, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    picked = ye[rows.reshape(-1)].reshape(G, sg, K, D)
    y = (wk.float()[..., None] * picked.float()).sum(2).to(x.dtype)
    y = y.reshape(B, S, D)
    if "shared_w_up" in p:
        hs = x @ p["shared_w_up"].to(x.dtype)
        gs = x @ p["shared_w_gate"].to(x.dtype)
        y = y + (F.silu(gs) * hs) @ p["shared_w_down"].to(x.dtype)
    return y, aux


def init_moe(gen: torch.Generator, cfg, *, layers, dtype=torch.float32,
             std=0.02, device=None):
    """Random MoE params drawn from ``gen`` (leaf order as the reference's
    ``init_moe``), stacked over ``layers`` unless it is None."""
    D, Fe, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    device = device or gen.device

    def w(*s):
        shape = s if layers is None else (layers, *s)
        return trunc_normal(gen, shape, std, dtype, device)

    p = {"w_router": w(D, E), "w_up": w(E, D, Fe), "w_gate": w(E, D, Fe),
         "w_down": w(E, Fe, D)}
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        p["shared_w_up"] = w(D, Fs)
        p["shared_w_gate"] = w(D, Fs)
        p["shared_w_down"] = w(Fs, D)
    return p
