"""AdamW, hand-rolled as in the reference package.

  * optional bf16 first/second moments;
  * optional f32 master copy when params are stored bf16;
  * global-norm clipping computed in f32;
  * the state mirrors the param tree leaf for leaf.

Bias corrections are float32 powers of the float32 step, as the reference
computes them, so the two packages' trajectories agree to rounding.
Updates return new tensors and leave their inputs untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"  # bfloat16 at scale
    master_weights: bool = False   # keep f32 master copy of bf16 params


def _corrections(step, b1, b2, device):
    stepf = torch.as_tensor(step, dtype=torch.float32, device=device)
    return 1.0 - b1 ** stepf, 1.0 - b2 ** stepf


def _leaf_update(p, m, v, g, *, lr, b1, b2, eps, weight_decay, c1, c2):
    """One AdamW step of a leaf in f32 -> (p32, m32, v32)."""
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * g32 * g32
    p32 = p.float()
    p32 = p32 - lr * ((m32 / c1) / (torch.sqrt(v32 / c2) + eps)
                      + weight_decay * p32)
    return p32, m32, v32


# ------------------------------------------------- minimal functional form
def adamw_init(params):
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(params, state, grads, step, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0):
    c1, c2 = _corrections(step, b1, b2, tree_leaves(params)[0].device)
    out = tree_map(lambda p, m, v, g: _leaf_update(
        p, m, v, g, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        c1=c1, c2=c2), params, state["m"], state["v"], grads)
    new_params = tree_map(lambda t, p: t[0].to(p.dtype), out, params)
    return new_params, {"m": tree_map(lambda t, _: t[1], out, params),
                        "v": tree_map(lambda t, _: t[2], out, params)}


# -------------------------------------------------- full configurable form
@torch.no_grad()
def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def make_optimizer(cfg: OptimizerConfig, schedule=None):
    """Returns (init_fn(params) -> state, update_fn(params, state, grads,
    step) -> (params, state, metrics))."""
    mdt = getattr(torch, cfg.moment_dtype)

    def init_fn(params):
        state = {"m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                               params),
                 "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                               params)}
        if cfg.master_weights:
            state["master"] = tree_map(lambda p: p.detach().float(), params)
        return state

    @torch.no_grad()
    def update_fn(params, state, grads, step):
        lr = cfg.lr if schedule is None else schedule(float(step))
        gnorm = global_norm(grads)
        metrics = {"grad_norm": gnorm, "lr": lr}
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
        c1, c2 = _corrections(step, cfg.b1, cfg.b2, gnorm.device)
        base = state.get("master", params)
        out = tree_map(lambda p, m, v, g: _leaf_update(
            p, m, v, g, lr=lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, c1=c1, c2=c2),
            base, state["m"], state["v"], grads)
        new_state = {"m": tree_map(lambda t, _: t[1].to(mdt), out, params),
                     "v": tree_map(lambda t, _: t[2].to(mdt), out, params)}
        if cfg.master_weights:
            new_state["master"] = tree_map(lambda t, _: t[0], out, params)
        new_params = tree_map(lambda t, p: t[0].to(p.dtype), out, params)
        return new_params, new_state, metrics

    return init_fn, update_fn
