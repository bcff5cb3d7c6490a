"""Growth baselines expressed in the same tensor-diagram algebra as Mango.

Per the paper's Fig. 5 / Table 1, bert2BERT and LiGO are special cases of
the TR-MPO operator:

  * bert2BERT — frozen cores: S_I = Net2Net split map, S_O = duplicate map,
    S_L = layer copy (AKI variant copies the *next* layer's knowledge for
    new depth), S_B = identity.  Nothing is trained.
  * LiGO      — trainable rank-1 S_I, S_O, S_L; S_B frozen to identity.
  * StackBERT — width-preserving, S_L = block-stacking map; S_I=S_O=S_B=I.

All of them go through the same packing/contract path as Mango (rank 1,
so through the sandwich); the only difference between methods is which
cores exist and which are trainable.  Frozen methods build float32 tensors
on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mango


def layer_map_stack(l1, l2):
    """StackBERT map: block-stack copies (l2 % l1 -> l2)."""
    mat = np.zeros((l1, l2), np.float32)
    for j in range(l2):
        mat[j % l1, j] = 1.0
    return torch.from_numpy(mat)


def layer_map_aki(l1, l2):
    """bert2BERT AKI-flavoured map: duplicated depth takes the *next*
    source layer's knowledge (advanced knowledge initialization)."""
    mat = np.zeros((l1, l2), np.float32)
    for j in range(l2):
        base = int(j * l1 / l2)
        src = min(base + (1 if j >= l1 else 0), l1 - 1)
        mat[src, j] = 1.0
    return torch.from_numpy(mat)


def _identity_cores(dims, s_i, s_o, s_l, s_b=None):
    """Assemble rank-1 cores from explicit (mode) matrices."""
    def lift(m):
        return m[None, :, :, None].float()
    if s_b is None:
        s_b = torch.eye(dims["B1"], dims["B2"], device=s_i.device)
    return {"S_B": lift(s_b), "S_I": lift(s_i), "S_O": lift(s_o),
            "S_L": lift(s_l)}


def init_bert2bert_params(op: mango.MangoOperator, aki=True, device="cpu"):
    """Frozen function-preserving cores (not trained)."""
    p = {"groups": {}, "aux": {}}
    d1, d2 = op.plan_src.d_model, op.plan_tgt.d_model
    for g in op.plan_src.groups:
        dims = op.dims(g.name)
        lm = (layer_map_aki if aki else mango.layer_map_matrix)(
            dims["L1"], dims["L2"]).to(device)
        p["groups"][g.name] = _identity_cores(
            dims,
            s_i=mango.width_expand_matrix(d1, d2, normalized=True).to(device),
            s_o=mango.width_expand_matrix(d1, d2, normalized=False).to(device),
            s_l=lm)
        p["aux"][f"{g.name}.layers"] = lm
    p["aux"]["width"] = {f"{d1}->{d2}": mango.width_expand_matrix(
        d1, d2, normalized=False).to(device)}
    return p


def init_ligo_params(gen: torch.Generator, op: mango.MangoOperator,
                     noise=0.01):
    """Trainable S_I/S_O/S_L, frozen-identity S_B, on ``gen``'s device.

    Returned params hold only the mode *matrices*; ``ligo_to_cores``
    assembles full rank-1 cores at grow time so gradients never touch S_B.
    """
    dev = gen.device
    d1, d2 = op.plan_src.d_model, op.plan_tgt.d_model

    def rnd(*shape):
        return noise * torch.randn(shape, generator=gen, device=dev)

    p = {"groups": {}, "aux": {}}
    for g in op.plan_src.groups:
        dims = op.dims(g.name)
        lm = mango.layer_map_matrix(dims["L1"], dims["L2"]).to(dev)
        p["groups"][g.name] = {
            "W_I": mango.width_expand_matrix(d1, d2, True).to(dev)
            + rnd(d1, d2),
            "W_O": mango.width_expand_matrix(d1, d2, False).to(dev)
            + rnd(d1, d2),
            "W_L": lm + rnd(dims["L1"], dims["L2"]),
        }
        p["aux"][f"{g.name}.layers"] = lm
    p["aux"]["width"] = {f"{d1}->{d2}": mango.width_expand_matrix(
        d1, d2, False).to(dev)}
    return p


def ligo_to_cores(op: mango.MangoOperator, ligo_params):
    """LiGO mode matrices -> full core dict usable by mango.grow."""
    p = {"groups": {}, "aux": ligo_params["aux"]}
    for g in op.plan_src.groups:
        dims = op.dims(g.name)
        gp = ligo_params["groups"][g.name]
        p["groups"][g.name] = _identity_cores(
            dims, s_i=gp["W_I"], s_o=gp["W_O"], s_l=gp["W_L"])
    return p


def init_stackbert_params(op: mango.MangoOperator, device="cpu"):
    """Width-preserving depth stacking (requires d1 == d2)."""
    d1, d2 = op.plan_src.d_model, op.plan_tgt.d_model
    if d1 != d2:
        raise ValueError(f"StackBERT only grows depth (d_model {d1} -> {d2})")
    p = {"groups": {}, "aux": {}}
    eye = torch.eye(d1, device=device)
    for g in op.plan_src.groups:
        dims = op.dims(g.name)
        lm = layer_map_stack(dims["L1"], dims["L2"]).to(device)
        p["groups"][g.name] = _identity_cores(dims, s_i=eye, s_o=eye, s_l=lm)
        p["aux"][f"{g.name}.layers"] = lm
    p["aux"]["width"] = {f"{d1}->{d2}": eye}
    return p
