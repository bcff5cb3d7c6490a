"""Mango: the multi-linear (TR-MPO) full-mapping growth operator (Eq. 5/6).

The full mapping tensor S ∈ R^{B1×I1×O1×L1×B2×I2×O2×L2} is decomposed into
four ring-bonded cores

    S_B (R1,B1,B2,R2)  S_O (R2,O1,O2,R3)  S_L (R3,L1,L2,R4)  S_I (R4,I1,I2,R1)

and the growth M2 = M1 ×_S is evaluated without materializing S.  At ring
rank 1 (the paper's rank, and the only one the baselines build) the chain
is one sandwich and two small mixes:

    X[(b,l)]    = M1[b,:,:,l]                           (B1·L1, I1, O1)
    Y           = S_I[0,:,:,0]^T · X · S_O[0,:,:,0]     (B1·L1, I2, O2)
    M2[c,j,m,n] = Σ_{b,l} S_B[0,b,c,0] · S_L[0,l,n,0] · Y[(b,l),j,m]

and the sandwich runs through ``kernels.ops.tr_sandwich`` (the CUDA kernel
on the card).  Higher ranks take the reference package's four-step einsum
chain.  The route is chosen from the cores' ranks, which the operator's
config fixes.

Structured init: the rank-0 component of the cores reproduces a
function-preserving-style expansion (Net2Net width duplication on S_I/S_O,
modular layer copy on S_L, identity on S_B) so operator training (Eq. 7)
starts from a sane growth; the other rank components start near zero.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.kernels import ops
from repro_torch.models import get_family
from repro_torch.utils.pytree import (
    get_path,
    set_path,
    tree_flatten_with_paths,
)


# ------------------------------------------------------------ core tensors
def width_expand_matrix(d1, d2, normalized=True):
    """Net2Net-style (d1, d2) expansion: col j2 copies col (j2 % d1);
    duplicated source columns are split (divided by multiplicity) so that
    compositions approximately preserve function.  A float32 CPU tensor."""
    idx = np.arange(d2) % d1
    mat = np.zeros((d1, d2), np.float32)
    counts = np.bincount(idx, minlength=d1).astype(np.float32)
    for j2, j1 in enumerate(idx):
        mat[j1, j2] = 1.0 / counts[j1] if normalized else 1.0
    return torch.from_numpy(mat)


def layer_map_matrix(l1, l2):
    """(l1, l2): target layer copies source layer (interleaved stacking)."""
    mat = np.zeros((l1, l2), np.float32)
    for j in range(l2):
        mat[int(j * l1 / l2), j] = 1.0
    return torch.from_numpy(mat)


def init_cores(gen: torch.Generator, dims, rank, noise=0.01,
               structured=True):
    """dims: dict with B1,B2,I1,I2,O1,O2,L1,L2. rank: int or 4-tuple.
    Noise is drawn from ``gen`` on its device."""
    if isinstance(rank, int):
        rank = (rank,) * 4
    R1, R2, R3, R4 = rank
    dev = gen.device

    def core(r_in, a, b, r_out, base):
        c = noise * torch.randn((r_in, a, b, r_out), generator=gen,
                                device=dev)
        if structured:
            c[0, :, :, 0] += base.to(dev)
        return c

    sb = core(R1, dims["B1"], dims["B2"], R2,
              torch.eye(dims["B1"], dims["B2"]))
    so = core(R2, dims["O1"], dims["O2"], R3,
              width_expand_matrix(dims["O1"], dims["O2"], normalized=False))
    sl = core(R3, dims["L1"], dims["L2"], R4,
              layer_map_matrix(dims["L1"], dims["L2"]))
    si = core(R4, dims["I1"], dims["I2"], R1,
              width_expand_matrix(dims["I1"], dims["I2"], normalized=True))
    return {"S_B": sb, "S_O": so, "S_L": sl, "S_I": si}


def _rank1(cores):
    return all(c.shape[0] == 1 and c.shape[3] == 1 for c in cores.values())


def _contract_rank1(M1, sb, so, sl, si):
    """The rank-1 contraction as one sandwich (I and O modes) and two mixes
    (L, then B).  M1 (B1, I1, O1, L1) -> M2 (B2, I2, O2, L2), returned as a
    view of a contiguous (B2, L2, I2, O2) tensor."""
    B1, I1, O1, L1 = M1.shape
    dt = torch.promote_types(M1.dtype, si.dtype)
    # a view of pack_group's contiguous (B1, L1, I1, O1) stack: no copy
    x = M1.permute(0, 3, 1, 2).reshape(B1 * L1, I1, O1).to(dt).contiguous()
    y = ops.tr_sandwich(x, si.to(dt).contiguous(), so.to(dt).contiguous())
    I2, O2 = y.shape[1:]
    y = y.reshape(B1, L1, I2 * O2)
    t = torch.einsum("blq,ln->bnq", y, sl.to(dt))
    m2 = torch.einsum("bnq,bc->cnq", t, sb.to(dt))
    return m2.reshape(sb.shape[1], sl.shape[1], I2, O2).permute(0, 2, 3, 1)


def contract(M1, cores):
    """M1 (B1,I1,O1,L1) x cores -> M2 (B2,I2,O2,L2)."""
    sb, so, sl, si = (cores[k] for k in ("S_B", "S_O", "S_L", "S_I"))
    if _rank1(cores):
        return _contract_rank1(M1, sb[0, :, :, 0], so[0, :, :, 0],
                               sl[0, :, :, 0], si[0, :, :, 0])
    t = torch.einsum("biol,pbcq->iolpcq", M1, sb)
    t = torch.einsum("iolpcq,qomr->ilpcrm", t, so)
    t = torch.einsum("ilpcrm,rlns->ipcmsn", t, sl)
    return torch.einsum("ipcmsn,sijp->cjmn", t, si)  # (B2, I2, O2, L2)


def contract_reference(M1, cores):
    """Single 8-index einsum straight from Eq. 6 (oracle for tests)."""
    return torch.einsum(
        "biol,pbcq,qomr,rlns,sijp->cjmn",
        M1, cores["S_B"], cores["S_O"], cores["S_L"], cores["S_I"])


def contract_flops(dims, rank):
    """Total multiply-add FLOPs (x2) of the 4-step chain."""
    if isinstance(rank, int):
        rank = (rank,) * 4
    R1, R2, R3, R4 = rank
    B1, B2 = dims["B1"], dims["B2"]
    I1, I2 = dims["I1"], dims["I2"]
    O1, O2 = dims["O1"], dims["O2"]
    L1, L2 = dims["L1"], dims["L2"]
    f = 0
    f += B1 * I1 * O1 * L1 * R1 * B2 * R2          # step 1
    f += I1 * O1 * L1 * R1 * B2 * R2 * O2 * R3     # step 2
    f += I1 * L1 * R1 * B2 * O2 * R3 * L2 * R4     # step 3
    f += I1 * R1 * B2 * O2 * L2 * R4 * I2          # step 4
    return 2 * f


# ------------------------------------------------------- the full operator
@dataclasses.dataclass(frozen=True)
class MangoOperator:
    """Static description of a growth  M(cfg_src) -> M(cfg_tgt)."""
    cfg_src: Any
    cfg_tgt: Any
    plan_src: packing.Plan
    plan_tgt: packing.Plan
    rank: Any = 1

    def dims(self, gname):
        gs = {g.name: g for g in self.plan_src.groups}[gname]
        gt = {g.name: g for g in self.plan_tgt.groups}[gname]
        if len(gs.slots) != len(gt.slots):
            raise ValueError(f"slot mismatch in {gname}: {len(gs.slots)} "
                             f"vs {len(gt.slots)}")
        return {
            "B1": len(gs.slots), "B2": len(gt.slots),
            "I1": self.plan_src.d_model, "I2": self.plan_tgt.d_model,
            "O1": self.plan_src.d_model, "O2": self.plan_tgt.d_model,
            "L1": gs.n_layers, "L2": gt.n_layers,
        }


def _shapes(cfg):
    return get_family(cfg).param_shapes(cfg)


def build_operator(cfg_src, cfg_tgt, rank=1) -> MangoOperator:
    if cfg_src.family != cfg_tgt.family:
        raise ValueError(f"growth needs one family: {cfg_src.family} -> "
                         f"{cfg_tgt.family}")
    plan_src = packing.build_plan(cfg_src, _shapes(cfg_src))
    plan_tgt = packing.build_plan(cfg_tgt, _shapes(cfg_tgt))
    return MangoOperator(cfg_src, cfg_tgt, plan_src, plan_tgt, rank)


def init_operator_params(gen: torch.Generator, op: MangoOperator,
                         noise=0.01):
    """Trainable params on ``gen``'s device: per-group TR cores + aux
    vector/width operators."""
    dev = gen.device
    p: Dict[str, Any] = {"groups": {}, "aux": {}}
    for g_src, g_tgt in zip(op.plan_src.groups, op.plan_tgt.groups):
        dims = op.dims(g_src.name)
        p["groups"][g_src.name] = init_cores(gen, dims, op.rank, noise=noise)
        # aux layer-mix for per-layer vectors of this group
        p["aux"][f"{g_src.name}.layers"] = layer_map_matrix(
            g_src.n_layers, g_tgt.n_layers).to(dev)
    # one width matrix per (d1 -> d2); duplication (not split) is the
    # function-preserving choice for embeddings and norm scales
    d1, d2 = op.plan_src.d_model, op.plan_tgt.d_model
    p["aux"]["width"] = {f"{d1}->{d2}": width_expand_matrix(
        d1, d2, normalized=False).to(dev)}
    return p


def _grow_vector_stack(vec1, layer_mat, width_mats, d1, d2, tgt_shape):
    """(L1, n1) -> (L2, n2): layer mix then width expansion on last axis."""
    L2, n2 = tgt_shape
    v = torch.einsum("ln,lm->mn", vec1.float(), layer_mat)
    n1 = v.shape[-1]
    if n1 != n2:
        v = v @ _width_for(width_mats, n1, n2, d1, d2)
    return v


def _width_for(width_mats, n1, n2, d1, d2):
    """Width matrix for an (n1 -> n2) axis, derived from the trainable
    (d1 -> d2) matrix when the axis is a multiple of d_model, else a fixed
    Net2Net map (cheap, non-trainable — e.g. odd head_dim paddings)."""
    key = f"{n1}->{n2}"
    if key in width_mats:
        return width_mats[key]
    base = width_mats[f"{d1}->{d2}"]
    if n1 == d1 and n2 == d2:
        return base
    if n1 % d1 == 0 and n2 % d2 == 0 and n1 // d1 == n2 // d2:
        return torch.block_diag(*([base] * (n1 // d1)))
    return width_expand_matrix(n1, n2).to(base.device)


def grow(op: MangoOperator, op_params, params_src, dtype=None):
    """Differentiable growth: source params -> target params."""
    shapes_tgt = _shapes(op.cfg_tgt)
    dtype = dtype or getattr(torch, op.cfg_tgt.param_dtype)
    d1, d2 = op.plan_src.d_model, op.plan_tgt.d_model
    width_mats = op_params["aux"]["width"]
    out: Dict[str, Any] = {}

    for g_src, g_tgt in zip(op.plan_src.groups, op.plan_tgt.groups):
        gname = g_src.name
        M1 = packing.pack_group(g_src, params_src[gname], d1,
                                dtype=getattr(torch, op.cfg_src.param_dtype))
        M2 = contract(M1, op_params["groups"][gname]).to(dtype)
        grown = packing.unpack_group(g_tgt, M2, shapes_tgt[gname], d2)
        # per-layer vectors via aux ops
        lmat = op_params["aux"][f"{gname}.layers"]
        for v in g_src.vectors:
            grown[v.path] = _grow_vector_stack(
                get_path(params_src[gname], v.path), lmat, width_mats, d1,
                d2, tuple(get_path(shapes_tgt[gname], v.path)))
        out[gname] = {}
        for path, val in grown.items():
            set_path(out[gname], path, val)

    # global leaves: every mismatched axis expanded by a width matrix
    for wref in op.plan_tgt.widths:
        leaf1 = get_path(params_src, wref.path)
        tgt_shape = tuple(get_path(shapes_tgt, wref.path))
        x = leaf1.float()
        for ax, (n1, n2) in enumerate(zip(leaf1.shape, tgt_shape)):
            if n1 != n2:
                x = torch.movedim(torch.movedim(x, ax, -1) @ _width_for(
                    width_mats, n1, n2, d1, d2), -1, ax)
        set_path(out, wref.path, x)
    _copy_missing(out, params_src, shapes_tgt)
    return _cast_like(out, shapes_tgt, dtype)


def _cast_like(out, shapes_tgt, dtype):
    """Every leaf of ``out`` in ``dtype`` and its target shape."""
    return {k: _cast_like(v, shapes_tgt[k], dtype) if isinstance(v, dict)
            else v.to(dtype).reshape(shapes_tgt[k]) for k, v in out.items()}


def _copy_missing(out, params_src, shapes_tgt):
    """Copy through any target leaf the operator did not produce (e.g.
    same-shape scalars); its source must have the target's shape."""
    for path, shape in tree_flatten_with_paths(shapes_tgt):
        try:
            get_path(out, path)
        except (KeyError, IndexError, TypeError):
            src = get_path(params_src, path)
            if tuple(src.shape) != tuple(shape):
                raise ValueError(f"uncovered leaf {path}: {tuple(src.shape)}"
                                 f" vs {tuple(shape)}")
            set_path(out, path, src)

