"""Shared building blocks: inits, norms, activation, cache-length quantum.

Params are nested dicts of tensors, stacked over the layer axis (leading
``L``) exactly as in the reference package, so converted weights line up
leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import paged_ring_restore_sites
from repro_torch.utils.pytree import tree_map


def trunc_normal(gen: torch.Generator, shape, std=0.02, dtype=torch.float32,
                 device=None):
    """``std`` times a standard normal truncated to [-2, 2], drawn on
    ``device`` (default: the generator's; on ``meta`` nothing is drawn)."""
    t = torch.empty(shape, dtype=torch.float32, device=device or gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # in place: a leaf never needs two f32 copies at once (deepseek-v3's
    # expert leaves are 15 GB each at full width)
    return t.mul_(std).to(dtype)


def meta_shapes(init, cfg) -> dict:
    """``init(gen, cfg, device)``'s tree with a ``torch.Size`` at every
    leaf, computed on the meta device: nothing is drawn or allocated (the
    reference package's ``jax.eval_shape`` of ``init``)."""
    params = init(torch.Generator(), cfg, device="meta")
    return tree_map(lambda t: t.shape, params)


def rms_norm(x, scale, eps=1e-6):
    """``x / sqrt(mean(x^2) + eps) * scale`` with float32 statistics."""
    return F.rms_norm(x.float(), (x.shape[-1],), scale.float(),
                      eps).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """``(x - mean) / sqrt(var + eps) * scale + bias`` (biased variance)
    with float32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                        None if bias is None else bias.float(),
                        eps).to(x.dtype)


def apply_norm(x, p, kind, eps=1e-6):
    # eps 1e-6 for LayerNorm too, as the reference package does
    if kind == "rms":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p.get("bias"), eps)


def init_norm(kind, dim, layers=None, dtype=torch.float32, device="cpu"):
    shape = (dim,) if layers is None else (layers, dim)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def gelu(x):
    return F.gelu(x, approximate="tanh")


def pad_cache_len(n: int) -> int:
    """Slot-pool cache length for ``max_len`` positions: above 256 rounds
    up to a multiple of 64, otherwise to a multiple of 8.  Kept from the
    reference package's pool layout so both packages allocate the same
    shapes; the padded tail is masked by each row's ``kv_len``."""
    q = 8 if n <= 256 else 64
    return -(-n // q) * q


def take_layer(stacked, i):
    """Layer ``i`` of every leaf of a stacked-params subtree (views)."""
    return {k: take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def slice_layers(stacked, start, stop):
    """Layers ``start:stop`` of every leaf of a stacked subtree (views)."""
    return {k: slice_layers(v, start, stop) if isinstance(v, dict)
            else v[start:stop] for k, v in stacked.items()}


def freeze_rows(old, new, done):
    """Per-row freeze for the continuous-batching slot protocol: rows
    flagged in ``done`` (B,) keep ``old``'s values, the rest take
    ``new``'s.  ``old``/``new`` are matching trees whose leaves lead with
    the batch (slot) axis.  A ``torch.where`` on the flag: no host sync,
    and a frozen row's bytes stay bit for bit (a recurrent update is
    irreversible, unlike a KV write that can store the same bytes again).
    """
    if isinstance(new, dict):
        return {k: freeze_rows(old[k], v, done) for k, v in new.items()}
    return torch.where(done.reshape(done.shape + (1,) * (new.dim() - 1)),
                       old, new)


# ------------------------------------------- speculative-decode slot hooks
def spec_verify_scan(step_fn, params, tokens, positions, cache, cfg,
                     done=None, stack_filter=None):
    """Generic ``verify_step_slots`` for recurrent slot layouts.

    Runs the family's single-token ``decode_step_slots`` over the chunk
    axis, a Python loop of S steps that updates ``cache`` in place, and
    stacks a copy of the slot state after each step: a recurrence has no
    one-shot parallel verify, but its per-slot state is O(1), so keeping
    it at every chunk position is cheap and gives exact per-row rollback.
    Each step runs the (B, 1) slot-decode arithmetic of the sequential
    path, so logits and committed state equal feeding the chunk token by
    token.

    ``stack_filter`` selects the sub-tree of the cache to stack: griffin
    stacks only its O(1) recurrent leaves and commits its O(window)
    local-attention rings by restoring write sites (``spec_ring_restore``).
    ``step_fn`` may return None for the logits (a draft's catch-up needs
    no head); the logits are then None too.

    tokens: (B, S) chunk per slot; positions: (B,) per-row start offsets.
    Returns (logits (B, S, V) or None, stacked, cache): ``stacked`` mirrors
    the (filtered) cache tree with a leading chunk axis -- ``stacked[j]``
    is the state after each row fed its first ``j + 1`` chunk tokens --
    and ``cache`` is the post-chunk cache (the same dict, updated).
    """
    S = tokens.shape[1]
    logits, stacked = [], None
    for j in range(S):
        out, cache = step_fn(params, tokens[:, j].contiguous(),
                             positions + j, cache, cfg, done=done)
        logits.append(out)
        ys = cache if stack_filter is None else stack_filter(cache)
        if stacked is None:  # each step's state is copied once, into place
            stacked = tree_map(lambda t: t.new_empty((S,) + t.shape), ys)
        tree_map(lambda buf, t: buf[j].copy_(t), stacked, ys)
    if logits[0] is None:
        return None, stacked, cache
    return torch.stack(logits, 1), stacked, cache


def spec_commit_gather(old, stacked, n_feed, done=None):
    """Generic ``commit_slots`` for recurrent (O(1)-per-slot) leaves.

    ``old`` is the pre-chunk state tree of (L, B, ...) leaves, ``stacked``
    the per-step states of ``spec_verify_scan`` (S, L, B, ...).  Row ``b``
    gets ``stacked[n_feed[b] - 1]``, the state after its first
    ``n_feed[b]`` chunk feeds; rows with ``n_feed == 0`` (or flagged
    ``done``) keep ``old``.  The rejected tail of the chunk never reaches
    the committed state because the gather predates it.  Returns a new
    tree.
    """
    keep = n_feed <= 0
    if done is not None:
        keep = keep | done
    idx = (n_feed - 1).clamp(min=0).long()

    def per_leaf(o, st):
        B = o.shape[1]
        shape = (1, 1, B) + (1,) * (o.dim() - 2)
        sel = st.gather(0, idx.reshape(shape).expand((1,) + o.shape))[0]
        return torch.where(keep.reshape((1, B) + (1,) * (o.dim() - 2)),
                           o, sel)

    return tree_map(per_leaf, old, stacked)


def ring_write_slots(positions, chunk_len, ring):
    """(B, chunk) ring slots ``(positions[b] + j) % ring`` that a run of
    ``chunk_len`` slot-decode steps from ``positions`` writes."""
    j = torch.arange(chunk_len, dtype=positions.dtype,
                     device=positions.device)
    return ((positions[:, None] + j[None]) % ring).long()


def spec_ring_sites(group, positions, chunk_len):
    """The bytes of a dense ring group at the slots a chunk of
    ``chunk_len`` steps from ``positions`` writes: {leaf: (L, B, chunk,
    ...)}, taken BEFORE the chunk runs so ``spec_ring_restore`` can put
    the rejected sites back.  O(chunk) a slot, never the whole ring."""
    ring = next(iter(group.values())).shape[2]
    sidx = ring_write_slots(positions, chunk_len, ring)
    rows = torch.arange(sidx.shape[0], device=sidx.device)[:, None]
    return {name: leaf[:, rows, sidx] for name, leaf in group.items()}


def spec_ring_restore(saved, group, positions, n_feed, chunk_len):
    """Commit ring-buffer leaves after a verify scan WITHOUT per-step
    stacking: keep the scan's bytes where the chunk write was accepted,
    put the pre-chunk bytes (``saved``, from ``spec_ring_sites``) back
    where it was rejected.  In place on ``group``'s (L, B, ring, ...)
    leaves; returns ``group``.

    Chunk index ``j`` wrote row ``b``'s slot ``(positions[b] + j) %
    ring`` and is rejected iff ``j >= n_feed[b]``.  Requires ``chunk_len
    <= ring`` (the speculative pair probe enforces ``d + 1 <= window``), so
    no slot is written twice within one chunk and every site is restored
    or kept unambiguously.  The reference masks the whole ring against a
    copy of it; only the chunk's sites can differ, so only they are
    written.
    """
    ring = next(iter(group.values())).shape[2]
    sidx = ring_write_slots(positions, chunk_len, ring)
    rows = torch.arange(sidx.shape[0], device=sidx.device)[:, None]
    j = torch.arange(chunk_len, device=n_feed.device)
    rejected = j[None] >= n_feed[:, None]  # (B, chunk)
    for name, leaf in group.items():
        cur = leaf[:, rows, sidx]
        mask = rejected.reshape((1,) + rejected.shape
                                + (1,) * (cur.dim() - 3))
        leaf[:, rows, sidx] = torch.where(mask, saved[name], cur)
    return group


def paged_spec_ring_sites(group, positions, chunk_len):
    """``spec_ring_sites`` over a PAGED ring group {"k"/"v": (L, n_pages +
    1, page, ...) arenas, "bt": (L, B, nblk)}: the pre-chunk bytes at each
    write site, resolved through the block table (a block the row never
    got reads the last real page; its restore goes to the scratch page)."""
    bt = group["bt"][0]  # layers share one table
    leaves = [k for k in group if k != "bt"]
    n_pages, page = group[leaves[0]].shape[1] - 1, group[leaves[0]].shape[2]
    zeros = torch.zeros_like(positions)
    _, pid_read, off = paged_ring_restore_sites(
        bt, positions, zeros, chunk_len, page, n_pages)
    return {key: group[key][:, pid_read.long(), off.long()]
            for key in leaves}


def paged_spec_ring_restore(saved, group, positions, n_feed, chunk_len):
    """``spec_ring_restore`` over a PAGED ring group: the scan wrote the
    whole chunk through the block table, so commit re-stores the pre-chunk
    bytes (``saved``, from ``paged_spec_ring_sites``) at every rejected
    write site (``j >= n_feed[b]``), resolved through the same table.
    Accepted sites -- and blocks the row never got -- are aimed at the
    scratch page ``n_pages``, which no read sees (the reference drops them
    at its out-of-range sentinel).  Sound because ring pages are
    slot-private (the prefix cache never aliases ring block tables) and
    ``chunk_len <= ring``.  In place; returns ``group``."""
    bt = group["bt"][0]
    leaves = [k for k in group if k != "bt"]
    n_pages, page = group[leaves[0]].shape[1] - 1, group[leaves[0]].shape[2]
    pid_restore, _, off = paged_ring_restore_sites(
        bt, positions, n_feed, chunk_len, page, n_pages)
    pid_restore, off = pid_restore.long(), off.long()
    for key in leaves:
        group[key][:, pid_restore, off] = saved[key]
    return group
