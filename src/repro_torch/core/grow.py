"""Unified growth API: build / grow / train-operator for all methods.

Procedure (paper §3.2 "Procedures of Applying Mango"):
 (i)   pack the pretrained M(L1,D1) into the weight tensor M1;
 (ii)  train the growth operator on the task loss for ~100 steps (Eq. 7) —
       only Mango and LiGO are trainable; bert2BERT/StackBERT are frozen;
 (iii) recover M2 through the operator;
 (iv)  split M2 into M(L2,D2) initial weights and continue normal training.

Operator params live on the device of the generator they are built from
(``build``'s ``gen``, or a generator on ``device``: CUDA unless asked for
the CPU); growth runs wherever its inputs are.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import baselines, mango
from repro_torch.models import get_family
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves

METHODS = ("mango", "ligo", "bert2bert", "stackbert", "net2net")


@dataclasses.dataclass(frozen=True)
class GrowthOperator:
    method: str
    op: mango.MangoOperator
    trainable: bool


def build(method: str, cfg_src, cfg_tgt, rank=1, gen=None, noise=None,
          device="cuda"):
    """-> (GrowthOperator, op_params) on ``gen``'s device (default: a
    generator on ``device`` seeded with 0; ``device`` is CUDA unless asked
    for the CPU, and a ``gen`` that is passed decides the device).

    ``noise`` scales the random component of the trainable methods'
    structured init (default 0.01).  ``noise=0`` makes an UNTRAINED mango
    operator coincide with the Net2Net expansion (width duplication +
    depth stacking), the most function-preserving init available."""
    if method not in METHODS:
        raise ValueError(f"unknown growth method {method!r}; one of "
                         f"{METHODS}")
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
    dev = gen.device
    op = mango.build_operator(cfg_src, cfg_tgt, rank=rank)
    kw = {} if noise is None else {"noise": noise}
    if method == "mango":
        return (GrowthOperator(method, op, True),
                mango.init_operator_params(gen, op, **kw))
    if method == "ligo":
        return (GrowthOperator(method, op, True),
                baselines.init_ligo_params(gen, op, **kw))
    if method == "stackbert":
        return (GrowthOperator(method, op, False),
                baselines.init_stackbert_params(op, device=dev))
    return (GrowthOperator(method, op, False),
            baselines.init_bert2bert_params(op, aki=method == "bert2bert",
                                            device=dev))


def grow_params(gop: GrowthOperator, op_params, params_src, dtype=None):
    """Differentiable for mango/ligo; pure function of frozen cores else."""
    if gop.method == "ligo":
        core_params = baselines.ligo_to_cores(gop.op, op_params)
    else:
        core_params = op_params
    return mango.grow(gop.op, core_params, params_src, dtype=dtype)


def operator_param_count(gop: GrowthOperator, op_params) -> int:
    """Trainable-parameter count (paper Table 1 comparisons)."""
    if not gop.trainable:
        return 0
    leaves = tree_leaves({"groups": op_params["groups"],
                          "width": op_params["aux"]["width"]})
    return sum(int(x.numel()) for x in leaves)


def grow_from_source(cfg_src, cfg_tgt, *, method="mango", rank=1, steps=0,
                     data_iter=None, params_src=None, seed=0, noise=None,
                     device="cuda", log_fn=print, return_source=False):
    """Full grow bootstrap: source init -> operator -> (optional Eq. 7
    operator training on ``data_iter``) -> grown target params.

    Shared by the train and serve launchers; pass ``params_src`` to grow
    from pretrained weights instead of a fresh init.  Everything is built
    on ``device`` (CUDA unless asked for the CPU) from a generator seeded
    with ``seed``.  ``return_source=True`` returns ``(grown, params_src)``
    (the source is a speculative server's draft).
    """
    from repro_torch.train.loss import loss_for

    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if params_src is None:
        params_src = get_family(cfg_src).init(gen, cfg_src)
    gop, op_params = build(method, cfg_src, cfg_tgt, rank=rank, gen=gen,
                           noise=noise)
    if steps:
        if data_iter is None:
            raise ValueError("operator training (steps > 0) needs data_iter")
        fam_tgt = get_family(cfg_tgt)
        loss_fn = loss_for(cfg_tgt)

        def op_loss(big, batch):
            logits, aux = fam_tgt.forward(big, batch, cfg_tgt)
            return loss_fn(logits, aux, batch, cfg_tgt)[0]

        op_params, losses = train_operator(gop, op_params, params_src,
                                           op_loss, data_iter, steps=steps)
        if losses:
            log_fn(f"[grow] {method} operator trained {len(losses)} "
                   f"steps: {losses[0]:.4f} -> {losses[-1]:.4f}")
    with torch.no_grad():
        grown = grow_params(gop, op_params, params_src)
    return (grown, params_src) if return_source else grown


def train_operator(gop: GrowthOperator, op_params, params_src, loss_fn,
                   data_iter, *, steps=100, lr=1e-3, weight_decay=1e-2):
    """Stage-(ii): optimize the operator on the task loss (Eq. 7) with the
    bare AdamW update (no clipping).

    ``loss_fn(big_params, batch) -> scalar`` — the target model's loss.
    Batches may hold numpy arrays or tensors; they are moved to the
    operator's device.  Frozen methods return their params unchanged.
    """
    if not gop.trainable:
        return op_params, []
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train.steps import value_and_grad

    dev = tree_leaves(op_params)[0].device

    def objective(p, batch):
        loss = loss_fn(grow_params(gop, p, params_src), batch)
        return loss, {"loss": loss}

    opt_state = adamw_init(op_params)
    losses = []
    for step in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(data_iter).items()}
        grads, metrics = value_and_grad(objective, op_params, batch)
        op_params, opt_state = adamw_update(
            op_params, opt_state, grads, step + 1, lr=lr,
            weight_decay=weight_decay)
        losses.append(float(metrics["loss"]))
    return op_params, losses
