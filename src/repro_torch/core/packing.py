"""Packing: model params  <->  Mango weight tensor  M ∈ (B, I, O, L).

The paper concatenates a vanilla transformer layer's {W^Q, W^K, W^V, W^O,
W^IN, W^OUT} into B = 2k+4 slots of (D × D) tiles (Fig. 4).  As in the
reference package:

 * every per-layer *matrix* leaf (L, a, b) is cut into ceil(a/D) x ceil(b/D)
   zero-padded (D x D) tiles — each tile is one B-slot;
 * 4-D expert leaves (L, E, a, b) contribute E x tiles slots;
 * block-diagonal leaves (L, H, w, w) are embedded as one dense (HW x HW)
   block-diagonal tile, blocks re-extracted after growth;
 * per-layer vectors are grown by a small auxiliary operator (layer-mix
   matrix + width matrix), see ``mango.grow``;
 * global leaves (embeddings, lm head, positional embeddings) are grown on
   their width axis by shared width matrices.

Slot order is the reference's: leaves sorted by their dotted path string,
so converted cores line up slot for slot.  ``pack_group`` stacks the tiles
contiguously as (B, L, D, D) and returns its (B, D, D, L) view, the
reference's public layout; ``mango.contract`` hands the contiguous stack to
the sandwich kernel as (B·L, D, D) without a copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.utils.pytree import get_path, tree_flatten_with_paths

# params groups that hold per-layer stacked weights, per family
BLOCK_GROUPS = ("dense_blocks", "moe_blocks", "rec_blocks", "attn_blocks",
                "m_blocks", "s_blocks")


@dataclasses.dataclass(frozen=True)
class SlotRef:
    path: str          # leaf path inside the group subtree
    kind: str          # "matrix" | "expert" | "blockdiag"
    leaf_shape: Tuple[int, ...]
    ti: int            # tile row index (input axis)
    tj: int            # tile col index (output axis)
    expert: int = -1   # expert index for 4-D leaves


@dataclasses.dataclass(frozen=True)
class VecRef:
    path: str
    leaf_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    name: str
    n_layers: int
    slots: Tuple[SlotRef, ...]
    vectors: Tuple[VecRef, ...]


@dataclasses.dataclass(frozen=True)
class WidthRef:
    path: str          # top-level leaf path
    leaf_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    d_model: int
    groups: Tuple[GroupPlan, ...]
    widths: Tuple[WidthRef, ...]


def _n_tiles(dim, d):
    return max(1, math.ceil(dim / d))


def build_plan(cfg, shapes) -> Plan:
    """shapes: nested dict with a shape (``torch.Size`` or tuple) at every
    leaf, e.g. ``transformer.param_shapes(cfg)``."""
    D = cfg.d_model
    groups: List[GroupPlan] = []
    widths: List[WidthRef] = []

    for gname in BLOCK_GROUPS:
        if gname not in shapes:
            continue
        slots: List[SlotRef] = []
        vecs: List[VecRef] = []
        n_layers = None
        for path, shp in tree_flatten_with_paths(shapes[gname]):
            shp = tuple(shp)
            if n_layers is None:
                n_layers = shp[0]
            if shp[0] != n_layers:
                raise ValueError(f"{gname}.{path}: leading axis {shp[0]} "
                                 f"is not the group's {n_layers} layers")
            if len(shp) == 2:
                vecs.append(VecRef(path, shp))
            elif len(shp) == 3:
                _, a, b = shp
                for ti in range(_n_tiles(a, D)):
                    for tj in range(_n_tiles(b, D)):
                        slots.append(SlotRef(path, "matrix", shp, ti, tj))
            elif len(shp) == 4:
                _, e, a, b = shp
                if a == b and a * e <= 4 * D and a < D:
                    # block-diagonal gate (L, H, w, w): one dense tile
                    nt = _n_tiles(a * e, D)
                    for ti in range(nt):
                        for tj in range(nt):
                            slots.append(
                                SlotRef(path, "blockdiag", shp, ti, tj))
                else:
                    for ex in range(e):
                        for ti in range(_n_tiles(a, D)):
                            for tj in range(_n_tiles(b, D)):
                                slots.append(
                                    SlotRef(path, "expert", shp, ti, tj, ex))
            else:
                raise ValueError(f"unsupported leaf rank: {path} {shp}")
        groups.append(GroupPlan(gname, n_layers, tuple(slots), tuple(vecs)))

    rest = {k: v for k, v in shapes.items() if k not in BLOCK_GROUPS}
    for path, shp in tree_flatten_with_paths(rest):
        widths.append(WidthRef(path, tuple(shp)))

    return Plan(D, tuple(groups), tuple(widths))


def _to_blockdiag(w):
    """(L, H, a, a) -> (L, H*a, H*a) dense block diagonal."""
    L, H, a, _ = w.shape
    eye = torch.eye(H, dtype=w.dtype, device=w.device)
    return (eye[None, :, None, :, None] *
            w[:, :, :, None, :]).reshape(L, H * a, H * a)


def _from_blockdiag(m, H, a):
    """(L, H*a, H*a) -> (L, H, a, a) extracting diagonal blocks."""
    L = m.shape[0]
    blocks = m.reshape(L, H, a, H, a)
    idx = torch.arange(H, device=m.device)
    return blocks[:, idx, :, idx, :].permute(1, 0, 2, 3)


def pack_group(group: GroupPlan, params_group, d_model: int,
               dtype=torch.float32):
    """-> M (B, D, D, L) in ``dtype``: a view of the contiguous (B, L, D, D)
    tile stack."""
    D = d_model
    tiles = []
    bd_cache = {}
    for s in group.slots:
        w = get_path(params_group, s.path)
        if s.kind == "blockdiag":
            if s.path not in bd_cache:
                bd_cache[s.path] = _to_blockdiag(w)
            w2 = bd_cache[s.path]  # (L, Ha, Ha)
        elif s.kind == "expert":
            w2 = w[:, s.expert]
        else:
            w2 = w
        i0, j0 = s.ti * D, s.tj * D
        tile = w2[:, i0:i0 + D, j0:j0 + D]
        tile = F.pad(tile, (0, D - tile.shape[2], 0, D - tile.shape[1]))
        tiles.append(tile.to(dtype))
    return torch.stack(tiles, 0).permute(0, 2, 3, 1)


def _assemble(tiles, nt_i, nt_j):
    """{(ti, tj): (L, D, D)} -> (L, nt_i*D, nt_j*D)."""
    return torch.cat([torch.cat([tiles[(ti, tj)] for tj in range(nt_j)], -1)
                      for ti in range(nt_i)], -2)


def unpack_group(group: GroupPlan, M2, target_group_shapes, d_model: int):
    """M2 (B, D2, D2, L2) -> dict of target-group matrix leaves (by path),
    differentiable in M2."""
    D = d_model
    out = {}
    per_path = {}
    for b_idx, s in enumerate(group.slots):
        per_path.setdefault(s.path, []).append((b_idx, s))

    def tile(b_idx):
        return M2[b_idx].permute(2, 0, 1)  # (L2, D2, D2)

    for path, entries in per_path.items():
        shp = tuple(get_path(target_group_shapes, path))
        kind = entries[0][1].kind
        if kind == "blockdiag":
            L, H, a, _ = shp
            nt = _n_tiles(a * H, D)
            full = _assemble({(s.ti, s.tj): tile(b) for b, s in entries},
                             nt, nt)
            out[path] = _from_blockdiag(full[:, :a * H, :a * H], H, a)
        elif kind == "expert":
            L, E, a, b = shp
            nt_i, nt_j = _n_tiles(a, D), _n_tiles(b, D)
            full = torch.stack([
                _assemble({(s.ti, s.tj): tile(bi) for bi, s in entries
                           if s.expert == ex}, nt_i, nt_j)
                for ex in range(E)], 1)
            out[path] = full[:, :, :a, :b]
        else:
            L, a, b = shp
            nt_i, nt_j = _n_tiles(a, D), _n_tiles(b, D)
            full = _assemble({(s.ti, s.tj): tile(bi) for bi, s in entries},
                             nt_i, nt_j)
            out[path] = full[:, :a, :b]
    return out
