"""Losses: next-token cross entropy with z-loss, and classification.

The MoE auxiliary and MTP terms of the reference package are not here:
configs with MoE layers or an MTP head are not ported (ROADMAP.md).
"""
from __future__ import annotations

import torch


def _ce(logits, targets, z_loss=0.0):
    """logits (..., V) any dtype; targets (...) int. f32 reduction."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


def lm_loss(logits, aux, batch, cfg, z_loss=1e-4):
    """Causal LM loss.  Encoder configs (non-causal LM heads) predict the
    *current* position of a masked stream instead of shifting."""
    tokens = batch["tokens"]
    if cfg.causal:
        loss = _ce(logits[:, :-1], tokens[:, 1:], z_loss).mean()
    else:
        mask = batch.get("mask")
        per = _ce(logits, tokens, z_loss)
        loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1) \
            if mask is not None else per.mean()
    return loss, {"ce": loss, "loss": loss}


def cls_loss(logits, aux, batch, cfg, z_loss=0.0):
    labels = batch["labels"]
    loss = _ce(logits, labels, z_loss).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def loss_for(cfg):
    return cls_loss if cfg.head == "cls" else lm_loss
