"""Losses: next-token cross entropy with z-loss, the MoE auxiliary term
and the MTP term, and classification."""
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
    """Causal LM loss (+ the MoE aux term, ``aux["moe_aux"]`` times
    ``cfg.aux_loss_weight``, when ``cfg.moe``; + ``cfg.mtp_weight`` times
    the MTP head's cross entropy against the token two ahead, metric
    ``"mtp"``, when ``aux`` has ``"mtp_logits"``).  Encoder configs
    (non-causal LM heads) predict the *current* position of a masked
    stream instead of shifting."""
    tokens = batch["tokens"]
    if cfg.causal:
        loss = _ce(logits[:, :-1], tokens[:, 1:], z_loss).mean()
    else:
        mask = batch.get("mask")
        per = _ce(logits, tokens, z_loss)
        loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1) \
            if mask is not None else per.mean()
    metrics = {"ce": loss}
    if aux.get("moe_aux") is not None and cfg.moe:
        # a tensor even where no MoE layer made one (an MoE config cut to
        # its dense layers sums to 0.0), as the reference's f32 scalar is
        moe_aux = torch.as_tensor(aux["moe_aux"] * cfg.aux_loss_weight,
                                  dtype=torch.float32, device=loss.device)
        loss = loss + moe_aux
        metrics["moe_aux"] = moe_aux
    if "mtp_logits" in aux:
        # depth-1 MTP predicts token t + 2 from position t
        mtp = _ce(aux["mtp_logits"][:, :-1], tokens[:, 2:], z_loss).mean()
        loss = loss + cfg.mtp_weight * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def cls_loss(logits, aux, batch, cfg, z_loss=0.0):
    labels = batch["labels"]
    loss = _ce(logits, labels, z_loss).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def loss_for(cfg):
    return cls_loss if cfg.head == "cls" else lm_loss
