"""Transformer family: dense decoder LMs, MoE decoders and DeepSeek's
latent attention.

Covers the paper's GPT/BERT/DeiT configs, the RoPE decoders (qwen1.5,
qwen3, stablelm, yi), qwen2-vl (multimodal RoPE), the hubert encoder
(continuous inputs, non-causal), the MoE decoders (phi3.5-moe) and
deepseek-v3 (MLA, MoE and the MTP head): LayerNorm or RMSNorm, GELU or
gated MLPs, learned absolute positions, standard (optionally partial) RoPE
or M-RoPE, qkv bias and per-head q/k norms, MHA or GQA attention,
separate or tied LM head, and a causal sliding window.  Params are nested
dicts stacked over a leading layer axis, as in the reference package.

Multi-head latent attention (``cfg.mla``, arXiv:2412.19437) caches two
latents a token instead of K/V: ``"ckv"`` (kv_lora_rank wide) and
``"kr"`` (the shared RoPE key, qk_rope_dim wide), in every cache group
and on both pools.  Its RoPE turns only the qk_rope_dim parts of q and k,
fully, whatever ``cfg.rope`` says.  The uncached forward and the cached
prefill expand K/V through ``w_uk``/``w_uv`` and attend in (qk_nope_dim +
qk_rope_dim, v_head_dim) dims; decode (scalar and slot, dense and paged)
and the speculative verify fold ``w_uk`` into q and attend in the latent
space (``_mla_absorbed_decode``, ``_mla_chunk_verify``).  Both are plain
PyTorch products, as in the reference (which has no Pallas kernel for
MLA): no attention kernel is reached on an MLA config.  A paged latent
group reads its pages through ``ops.paged_latent_gather``.  The MTP head
(``cfg.mtp``) adds ``params["mtp"]``, one dense block over the final
hidden state and the next token's embedding; ``forward`` returns its
logits as ``aux["mtp_logits"]`` (the loss's MTP term) and serving never
reads it.

An MoE config splits the stack into two block groups, as the reference
does: ``cfg.moe_layer_start`` dense blocks in ``params["dense_blocks"]``
(cache group ``"dense"``), then the rest in ``params["moe_blocks"]``
(cache group ``"moe"``), whose MLP is ``moe.moe_mlp``.  Every route walks
the groups in that order (``_groups``); ``forward`` returns the sum of the
MoE layers' auxiliary losses as ``aux["moe_aux"]``.  Routing capacity
counts per dispatch group, so a token's route depends on the batch shape
it is computed in (a bucket prefill's pads take part), exactly as in the
reference.

A windowed config (``cfg.window``) attends ``(qpos - window, qpos]``.
Its forward and prefill take the plain windowed attention (no flash
kernel, as in the reference); its slot cache is a ring of
``pad_cache_len(min(max_len, window))`` slots once that reaches the
window (``_is_ring``): position ``p`` lives at slot ``p % ring`` and every
read reconstructs each slot's absolute position.  The admission prefill
fills each row's ring from its true prompt length (``ring_fill_rows``),
the slot decode writes ``pos % ring`` and attends through
``ops.ring_decode_attention`` or, on a paged pool (ring modulus ``nblk *
page``), ``ops.paged_ring_decode_attention``; the verify passes
``ring=True`` to the chunk kernels and ``commit_slots`` writes the
accepted prefix at its ring slots.  A shorter cache never wraps and keeps
the full layout (every cached position then lies inside the window).

RoPE rotates q and k after the q/k norms and before any cache write, at
each token's absolute position: ``q_offset + arange(S)`` on the scalar
routes (or ``batch["positions"]``), each slot's own, unclamped position on
the slot routes, and ``positions[b] + arange(S)`` in speculative verify.
One (cos, sin) table per forward serves every layer.  M-RoPE takes (3, B,
S) positions, one stream each for t, h and w; a route that builds (B, S)
positions (every serving route) turns them into three equal streams, as
the reference does (``_rope``), and a given ``batch["positions"]`` of
three rows reaches no learned-position lookup.

Four call sites reach the hand-written kernels through ``kernels.ops``,
which picks kernel or plain version by the tensor's device:
  * causal cached prefill at ``q_offset == 0`` without a window ->
    ``ops.flash_attention`` (the kernel masks ragged tiles, so every
    prefill length takes it);
  * the scalar cached decode step (``decode_step``: S == 1 at one shared
    position) -> ``ops.decode_attention`` over the cache's head-major
    ``transpose(1, 2)`` view (strides, no copy);
  * continuous-batching slot decode -> ``ops.slot_decode_attention``, or
    ``ops.paged_slot_decode_attention`` over a paged pool (a ring: the
    two ring kernels above);
  * speculative verify of a chunk per slot -> ``ops.chunk_verify_attention``
    or ``ops.paged_chunk_verify_attention``, full or ring layout
    (``verify_step_slots``; ``commit_slots`` then writes the accepted
    prefix).
A paged cache group (``serve/paged.py``) carries a block table ``"bt"``
beside its page arenas; the slot-decode and verify paths detect it by
``"bt" in cache``.  Caches are updated in place (the reference package
returns new buffers, which XLA aliases through donation); the returned
cache is the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import (
    apply_norm,
    init_norm,
    meta_shapes,
    pad_cache_len,
    paged_spec_ring_restore,
    paged_spec_ring_sites,
    rms_norm,
    spec_ring_restore,
    spec_ring_sites,
    take_layer,
    trunc_normal,
)


def _groups(cfg):
    """The block groups in the reference's order: (params key, cache key,
    is-MoE, layer count) of the dense blocks, then of the MoE blocks; a
    group with no layers is absent."""
    n_dense = cfg.n_dense_layers
    out = []
    if n_dense:
        out.append(("dense_blocks", "dense", False, n_dense))
    if cfg.n_layers - n_dense:
        out.append(("moe_blocks", "moe", True, cfg.n_layers - n_dense))
    return out


# =============================================================== param init
def _attn_init(gen, cfg, layers, dtype, std, device):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    zeros = dict(dtype=dtype, device=device)

    def w(*shape):
        return trunc_normal(gen, shape, std, dtype, device)

    if cfg.mla:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        return {"w_dq": w(layers, D, qr),
                "q_norm": torch.ones((layers, qr), **zeros),
                "w_uq": w(layers, qr, H * (dn + dr)),
                "w_dkv": w(layers, D, kvr),
                "kv_norm": torch.ones((layers, kvr), **zeros),
                "w_kr": w(layers, D, dr),
                "w_uk": w(layers, kvr, H * dn),
                "w_uv": w(layers, kvr, H * dv),
                "wo": w(layers, H * dv, D)}
    p = {"wq": w(layers, D, H * hd), "wk": w(layers, D, KV * hd),
         "wv": w(layers, D, KV * hd), "wo": w(layers, H * hd, D)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((layers, H * hd), **zeros)
        p["bk"] = torch.zeros((layers, KV * hd), **zeros)
        p["bv"] = torch.zeros((layers, KV * hd), **zeros)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((layers, D), **zeros)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((layers, hd), **zeros)
        p["k_norm"] = torch.ones((layers, hd), **zeros)
    return p


def init(gen: torch.Generator, cfg, device=None) -> dict:
    """Random params drawn from ``gen``, on ``device`` (default: the
    generator's device)."""
    device = device or gen.device
    dtype = getattr(torch, cfg.param_dtype)
    std = 0.02
    D = cfg.d_model

    def w(*shape):
        return trunc_normal(gen, shape, std, dtype, device)

    params = {}
    if cfg.continuous_inputs:
        params["in_proj"] = w(cfg.continuous_inputs, D)
    else:
        params["embed"] = w(cfg.vocab_size, D)
    if cfg.learned_pos:
        params["pos_embed"] = w(cfg.learned_pos, D)
    for key, _, moe, n in _groups(cfg):
        params[key] = _block_group_init(gen, cfg, n, moe, dtype, std, device)
    params["final_norm"] = init_norm(cfg.norm, D, None, dtype, device)
    if cfg.head == "lm" and not cfg.tie_embeddings:
        params["head"] = w(D, cfg.vocab_size)
    elif cfg.head == "cls":
        params["cls_token"] = w(D)
        params["head"] = w(D, cfg.n_classes)
    if cfg.mtp:
        params["mtp"] = {
            "proj": w(2 * D, D),
            "norm_h": init_norm(cfg.norm, D, None, dtype, device),
            "norm_e": init_norm(cfg.norm, D, None, dtype, device),
            "block": _block_group_init(gen, cfg, 1, False, dtype, std,
                                       device)}
    return params


def _block_group_init(gen, cfg, n, moe, dtype, std, device):
    """One stacked group of ``n`` blocks, their MLP dense or MoE."""
    D = cfg.d_model
    grp = {"ln1": init_norm(cfg.norm, D, n, dtype, device),
           "ln2": init_norm(cfg.norm, D, n, dtype, device),
           "attn": _attn_init(gen, cfg, n, dtype, std, device)}
    if moe:
        grp["moe"] = moe_lib.init_moe(gen, cfg, layers=n, dtype=dtype,
                                      std=std, device=device)
    else:
        grp["mlp"] = ffn_lib.init_mlp(gen, D, cfg.d_ff, layers=n,
                                      act=cfg.act, bias=cfg.mlp_bias,
                                      dtype=dtype, std=std, device=device)
    return grp


def param_shapes(cfg) -> dict:
    """``init``'s shapes (``common.meta_shapes``)."""
    return meta_shapes(init, cfg)


# ============================================================ forward pieces
def _slot_kv_len(slot_positions, slot_done):
    """Per-row valid cache length for the slot-decode path; finished or
    idle rows (``slot_done``) get 0, so the kernel skips their reads."""
    kv = slot_positions + 1
    if slot_done is None:
        return kv
    return torch.where(slot_done, 0, kv)


def _is_ring(cache_len, window):
    """A window cache whose length reaches the window is a wrapping ring
    (slot = pos % cache_len); a shorter one never wraps and keeps the full
    layout.  ``>=``: the pool pads the cache axis, which may push a ring
    past the window, and masking by absolute position keeps a larger ring
    attend-identical."""
    return window is not None and cache_len >= window


def _cache_seq_len(cache):
    """Logical sequence length of a slot cache group: the cache axis of the
    dense layout, ``nblk * page`` through the block table of a paged group
    (whose arenas carry no per-slot sequence axis).  K/V leaves are (...,
    S, KV, hd), MLA's latents (..., S, r)."""
    n = cache["ckv"].shape[-2] if "ckv" in cache else cache["k"].shape[-3]
    if "bt" in cache:
        return cache["bt"].shape[-1] * n
    return n


def _paged_write_site(cache, arena, slot_positions, slot_done):
    """(page id, offset) of each row's slot-decode write into a paged
    group's ``arena`` (n_pages + 1, page, ...): page ``bt[b, pos // page]``
    at ``pos % page``, or the scratch page ``n_pages`` for a write that
    must be dropped -- a ``done`` row (whose table may be all-sentinel
    after eviction), a position past the row's pages (its table entry is
    the sentinel) or at or past ``nblk * page``."""
    bt = cache["bt"]
    n_pages, page = arena.shape[0] - 1, arena.shape[1]
    nblk = bt.shape[1]
    blk = slot_positions // page
    pid = bt.gather(1, blk.clamp(max=nblk - 1)[:, None])[:, 0].long()
    drop = slot_positions >= _cache_seq_len(cache)
    if slot_done is not None:
        drop = drop | slot_done
    return torch.where(drop, n_pages, pid), slot_positions % page


def _paged_slot_forward(q, cache, k, v, slot_positions, slot_kv_len,
                        slot_done, window, cdt):
    """Slot-decode step over one layer of a PAGED cache group (a ring:
    ``attention.paged_ring_slot_update_attend``).

    cache: {"k"/"v": (n_pages + 1, page, KV, hd), "bt": (B, nblk)}.  The
    write of row b resolves through its table (``_paged_write_site``); a
    write that must be dropped goes to the scratch page ``n_pages``,
    which no read sees (``serve/paged.py``).  Reads go to the paged slot
    kernel over the real pages only.  Returns (B, 1, H, hd).
    """
    if _is_ring(_cache_seq_len(cache), window):
        return attn_lib.paged_ring_slot_update_attend(
            q, cache, k, v, slot_positions, window=window, done=slot_done)
    ck, cv, bt = cache["k"], cache["v"], cache["bt"]
    n_pages = ck.shape[0] - 1
    pid, off = _paged_write_site(cache, ck, slot_positions, slot_done)
    ck[pid, off] = k[:, 0].to(ck.dtype)
    cv[pid, off] = v[:, 0].to(cv.dtype)
    out = ops.paged_slot_decode_attention(
        q[:, 0], ck[:n_pages].to(cdt), cv[:n_pages].to(cdt), bt, slot_kv_len)
    return out[:, None]


def _attn_forward(x, p, cfg, *, rope=None, cache=None, q_offset=0,
                  slot_positions=None, slot_kv_len=None, chunk_offsets=None,
                  slot_done=None, decode_kv_len=None, plens=None):
    """Returns (out, cache). x: (B,S,D).

    ``rope`` -- the (cos, sin) table of ``rope_lib.rope_tables`` at this
    forward's positions (None without RoPE): q and k turn after the q/k
    norms, before anything is written to the cache.

    ``decode_kv_len`` -- the scalar decode step's (B,) int32 valid length,
    ``q_offset + 1`` on every row, built once for all layers (None builds
    it from ``q_offset`` in the kernel's entry point).

    ``slot_positions`` (B,) switches to the continuous-batching decode
    path: S is 1, each row is an independent cache slot at its own length;
    the new K/V is written to ``cache[b, slot_positions[b]]`` and attention
    reads each row up to ``slot_kv_len[b]`` (0 for finished/idle rows).
    Finished rows write too: their position is past their last valid
    entry, so the write is never read before the slot is evicted.  A write
    position past the cache (a speculative draft's proposals beyond a
    row's budget) lands on the cache's last slot instead, which no row
    has committed (a row's length stays below ``max_len``) and which only
    such beyond-budget steps read.

    ``chunk_offsets`` (B,) switches to speculative verify: the S-token
    chunk of row b sits at ``chunk_offsets[b]`` and attends the read-only
    cache and itself (``slot_done`` rows give zeros).  The cache is not
    written; the second return value is the pending ``{"k", "v"}`` of the
    chunk, which ``commit_slots`` writes for the accepted prefix.

    Both routes take a paged cache group too (``"bt" in cache``): the
    slot route through ``_paged_slot_forward``, the verify route through
    the paged chunk kernel over the arenas' real pages.

    A ring cache (``_is_ring``; module docstring) writes slot ``pos %
    ring`` on every route; ``plens`` (B,), the true prompt lengths of a
    tail-padded admission prefill, fills each row's ring from its own
    length (a full cache hides the pad tail behind each row's length and
    ignores it).
    """
    if cfg.mla:
        # latent attention reaches no K/V branch (nor any kernel)
        return _mla_forward(x, p, cfg, rope=rope, cache=cache,
                            q_offset=q_offset, slot_positions=slot_positions,
                            slot_kv_len=slot_kv_len,
                            chunk_offsets=chunk_offsets, slot_done=slot_done)
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = x.dtype
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope is not None:
        q = rope_lib.rotate(q, rope)
        k = rope_lib.rotate(k, rope)

    window = cfg.window
    if chunk_offsets is not None:
        # the pool leaves as they are: no [cache ‖ chunk] copy
        ring = _is_ring(_cache_seq_len(cache), window)
        if "bt" in cache:
            n_pages = cache["k"].shape[0] - 1  # the scratch page stays unread
            out = ops.paged_chunk_verify_attention(
                q, cache["k"][:n_pages].to(cdt), cache["v"][:n_pages].to(cdt),
                cache["bt"], k, v, chunk_offsets, ring=ring, window=window,
                done=slot_done)
        else:
            out = ops.chunk_verify_attention(q, cache["k"].to(cdt),
                                             cache["v"].to(cdt), k, v,
                                             chunk_offsets, ring=ring,
                                             window=window, done=slot_done)
        return _attn_out(out, p, cfg, cdt), {"k": k, "v": v}
    if slot_positions is not None and "bt" in cache:
        out = _paged_slot_forward(q, cache, k, v, slot_positions,
                                  slot_kv_len, slot_done, window, cdt)
        return _attn_out(out, p, cfg, cdt), cache
    if slot_positions is not None and _is_ring(cache["k"].shape[1], window):
        # each row writes its ring slot ``pos % ring`` (done rows keep
        # their bytes) and attends by absolute position
        out = attn_lib.ring_slot_update_attend(q, cache, k, v,
                                               slot_positions, window=window,
                                               done=slot_done)
        return _attn_out(out, p, cfg, cdt), cache
    if slot_positions is not None:
        ck, cv = cache["k"], cache["v"]
        rows = torch.arange(B, device=x.device)
        wpos = slot_positions.clamp(max=_cache_seq_len(cache) - 1)
        ck[rows, wpos] = k[:, 0].to(ck.dtype)
        cv[rows, wpos] = v[:, 0].to(cv.dtype)
        out = ops.slot_decode_attention(q[:, 0], ck.to(cdt), cv.to(cdt),
                                        slot_kv_len)[:, None]
        return _attn_out(out, p, cfg, cdt), cache
    kv_len = None
    if cache is not None and _is_ring(cache["k"].shape[1], window):
        ck, cv = cache["k"], cache["v"]
        ring = ck.shape[1]  # the ring modulus (>= window once padded)
        if plens is not None and S > 1:
            # admission prefill of tail-padded prompts: each row's ring
            # from its TRUE length, by absolute position
            ck.copy_(attn_lib.ring_fill_rows(k, plens, ring, ck.dtype))
            cv.copy_(attn_lib.ring_fill_rows(v, plens, ring, cv.dtype))
        else:
            w_eff = min(S, ring)
            idx = (q_offset + S - w_eff
                   + torch.arange(w_eff, device=x.device)) % ring
            ck[:, idx] = k[:, -w_eff:].to(ck.dtype)
            cv[:, idx] = v[:, -w_eff:].to(cv.dtype)
        if S > 1:
            # prefill: windowed attention over the in-flight k/v
            out = attn_lib.attention(q, k, v, causal=cfg.causal,
                                     window=window, q_offset=q_offset,
                                     chunk_q=cfg.attn_chunk)
        else:
            kpos_abs = _ring_positions(q_offset + S, ring, x.device)
            out = _ring_window_attend(q, ck.to(cdt), cv.to(cdt), kpos_abs,
                                      q_offset, cfg)
        return _attn_out(out, p, cfg, cdt), cache
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, q_offset:q_offset + S] = k.to(ck.dtype)
        cv[:, q_offset:q_offset + S] = v.to(cv.dtype)
        k, v = ck.to(cdt), cv.to(cdt)
        kv_len = q_offset + S
        if S > 1 and cfg.causal and q_offset == 0 and window is None:
            # Cached prefill from position 0: causal flash attention over
            # exactly the S in-flight positions (kv_len == S masks nothing
            # beyond the causal band).  K/V are read back from the cache
            # so cache-dtype rounding matches the plain route.  Admission
            # rows padded past their prompt compute too, but stay unread.
            of = ops.flash_attention(q.transpose(1, 2),
                                     k[:, :S].transpose(1, 2),
                                     v[:, :S].transpose(1, 2), causal=True)
            return _attn_out(of.transpose(1, 2), p, cfg, cdt), cache
        if S == 1:
            # Scalar decode step: one query per row over the first
            # q_offset + 1 positions, through the head-major view of the
            # (B, S, KV, hd) cache (a transpose of strides, no copy).
            od = ops.decode_attention(
                q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                kv_len if decode_kv_len is None else decode_kv_len)
            return _attn_out(od[:, None], p, cfg, cdt), cache
    out = attn_lib.attention(q, k, v, causal=cfg.causal, window=window,
                             q_offset=q_offset, kv_len=kv_len,
                             chunk_q=cfg.attn_chunk)
    return _attn_out(out, p, cfg, cdt), cache


def _mla_forward(x, p, cfg, *, rope, cache=None, q_offset=0,
                 slot_positions=None, slot_kv_len=None, chunk_offsets=None,
                 slot_done=None):
    """DeepSeek-V3 multi-head latent attention: ``_attn_forward``'s routes
    over a latent cache group {"ckv": (B, Sc, kv_lora_rank), "kr": (B, Sc,
    qk_rope_dim)} (or their paged arenas and ``"bt"``).  ``rope`` is the
    (cos, sin) table at qk_rope_dim.  Returns (out, cache) -- on the verify
    route (out, the chunk's raw latents ``{"ckv", "kr"}``, the pending
    entry ``commit_slots`` writes)."""
    B, S, _ = x.shape
    cdt = x.dtype
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ p["w_dq"].to(cdt), p["q_norm"])
    q = (cq @ p["w_uq"].to(cdt)).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope_lib.rotate(q[..., dn:], rope)
    ckv = x @ p["w_dkv"].to(cdt)
    kr = rope_lib.rotate((x @ p["w_kr"].to(cdt))[:, :, None], rope)[:, :, 0]
    wo = p["wo"].to(cdt)

    if chunk_offsets is not None:
        # verify in the latent space over [cached latents ‖ the chunk's],
        # the cache read-only
        view = _mla_paged_gather(cache) if "bt" in cache else (
            cache["ckv"], cache["kr"])
        out = _mla_chunk_verify(q_nope, q_rope, view, ckv, kr, p, cfg,
                                chunk_offsets, slot_done)
        return out @ wo, {"ckv": ckv, "kr": kr}
    if slot_positions is not None:
        cc, cr = cache["ckv"], cache["kr"]
        if "bt" in cache:
            # the write through the block table (dropped writes to the
            # scratch page), then the absorbed attention over the
            # gathered view of the real pages
            pid, off = _paged_write_site(cache, cc, slot_positions,
                                         slot_done)
            cc[pid, off] = ckv[:, 0].to(cc.dtype)
            cr[pid, off] = kr[:, 0].to(cr.dtype)
            cc, cr = _mla_paged_gather(cache)
        else:
            # per-row scatter (a position past the cache clamps onto its
            # last slot, as the K/V route's does)
            rows = torch.arange(B, device=x.device)
            wpos = slot_positions.clamp(max=_cache_seq_len(cache) - 1)
            cc[rows, wpos] = ckv[:, 0].to(cc.dtype)
            cr[rows, wpos] = kr[:, 0].to(cr.dtype)
        out = _mla_absorbed_decode(q_nope, q_rope, cc.to(cdt), cr.to(cdt),
                                   p, cfg, kv_len=slot_kv_len)
        return out @ wo, cache
    kv_len = None
    if cache is not None:
        cc, cr = cache["ckv"], cache["kr"]
        cc[:, q_offset:q_offset + S] = ckv.to(cc.dtype)
        cr[:, q_offset:q_offset + S] = kr.to(cr.dtype)
        if S == 1:
            # absorbed decode: w_uk folded into q, attention in the
            # kv_lora space, w_uv after it
            out = _mla_absorbed_decode(q_nope, q_rope, cc.to(cdt),
                                       cr.to(cdt), p, cfg,
                                       kv_len=q_offset + 1)
            return out @ wo, cache
        ckv, kr = cc.to(cdt), cr.to(cdt)
        kv_len = q_offset + S
    # expanded K/V (the uncached forward, the cached prefill over the
    # cache up to q_offset + S)
    ckv_n = rms_norm(ckv, p["kv_norm"])
    k_nope = (ckv_n @ p["w_uk"].to(cdt)).reshape(B, -1, H, dn)
    v = (ckv_n @ p["w_uv"].to(cdt)).reshape(B, -1, H, cfg.v_head_dim)
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, kr[:, :, None].expand(-1, -1, H, dr)], -1)
    out = attn_lib.attention(qf, kf, v, causal=cfg.causal, q_offset=q_offset,
                             kv_len=kv_len, scale=(dn + dr) ** -0.5,
                             chunk_q=cfg.attn_chunk)
    return out.reshape(B, S, -1) @ wo, cache


def _mla_paged_gather(cache):
    """Dense (B, nblk * page, r) views of a paged latent group's real
    pages (the scratch page stays unread), through
    ``ops.paged_latent_gather``."""
    n_pages = cache["ckv"].shape[0] - 1
    return (ops.paged_latent_gather(cache["ckv"][:n_pages], cache["bt"]),
            ops.paged_latent_gather(cache["kr"][:n_pages], cache["bt"]))


def _mla_latent_attend(q_nope, q_rope, ckv, kr, p, cfg, mask):
    """Attention in the latent space: (B, S, H, dn/dr) queries over (B,
    Sk, r) latents under ``mask`` (B or 1, S, Sk); ``w_uk`` folds into q,
    ``w_uv`` follows the softmax.  Scores in f32.  Returns (B, S, H, dv)."""
    B, S, H, dn = q_nope.shape
    R, dv = cfg.kv_lora_rank, cfg.v_head_dim
    ckv_n = rms_norm(ckv, p["kv_norm"])
    w_uk = p["w_uk"].to(q_nope.dtype).reshape(R, H, dn)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    logits = torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv_n.float())
    logits = logits + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                                   kr.float())
    logits = logits * (dn + cfg.qk_rope_dim) ** -0.5
    logits = torch.where(mask[:, None], logits, attn_lib.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv_n)
    w_uv = p["w_uv"].to(ckv.dtype).reshape(R, H, dv)
    return torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)


def _mla_absorbed_decode(q_nope, q_rope, ckv, kr, p, cfg, *, kv_len):
    """One-token MLA attention in the latent space.  q_nope: (B, 1, H,
    dn); q_rope: (B, 1, H, dr); ckv: (B, Sc, r); kr: (B, Sc, dr); kv_len:
    an int (every row) or (B,) per-row lengths, whose rows of length 0
    (idle or finished slots) return exact zeros.  Returns (B, 1, H*dv)."""
    B = q_nope.shape[0]
    kpos = torch.arange(ckv.shape[1], device=ckv.device)
    per_row = torch.is_tensor(kv_len)
    if per_row:
        mask = (kpos[None] < kv_len[:, None])[:, None]  # (B, 1, Sc)
    else:
        mask = (kpos < kv_len)[None, None]
    out = _mla_latent_attend(q_nope, q_rope, ckv, kr, p, cfg, mask)
    if per_row:
        out = torch.where((kv_len > 0)[:, None, None, None], out, 0.0)
    return out.reshape(B, 1, -1)


def _mla_chunk_verify(q_nope, q_rope, cache, ckv, kr, p, cfg, offsets,
                      done):
    """Speculative-verify MLA attention: S chunk queries a row over
    [cached latents ‖ the chunk's raw latents], the cache read-only.
    ``cache`` = (ckv (B, Sc, r), kr (B, Sc, dr)); ckv/kr: the chunk's (B,
    S, ·); query j of row b sits at ``offsets[b] + j`` and reads cached
    positions below ``offsets[b]`` and chunk keys up to itself.  ``done``
    rows return exact zeros.  Returns (B, S, H*dv)."""
    B, S = q_nope.shape[:2]
    cc, cr = cache
    Sc = cc.shape[1]
    ckv_all = torch.cat([cc.to(ckv.dtype), ckv], 1)
    kr_all = torch.cat([cr.to(kr.dtype), kr], 1)
    offsets = offsets.long()
    kpos_c = torch.arange(Sc, device=ckv.device)[None].expand(B, Sc)
    kpos_c = torch.where(kpos_c < offsets[:, None], kpos_c, -1)
    steps = torch.arange(S, device=ckv.device)[None]
    kpos = torch.cat([kpos_c, offsets[:, None] + steps], 1)  # (B, Sc + S)
    qpos = offsets[:, None] + steps  # (B, S)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if done is not None:
        mask = mask & ~done[:, None, None]
    out = _mla_latent_attend(q_nope, q_rope, ckv_all, kr_all, p, cfg, mask)
    if done is not None:
        out = torch.where(done[:, None, None, None], 0.0, out)
    return out.reshape(B, S, -1)


def _attn_out(out, p, cfg, cdt):
    B, S = out.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"].to(cdt)
    if cfg.attn_out_bias:
        y = y + p["bo"].to(cdt)
    return y


def _ring_positions(cur_len, ring, device=None):
    """Absolute position held by each ring-buffer slot after ``cur_len``
    positions (one length for every row), -1 where unwritten: (ring,).
    ``ring`` is the cache length (the ring modulus), not the window."""
    slot = torch.arange(ring, device=device)
    base = ((cur_len - 1) // ring) * ring + slot
    pos = torch.where(base < cur_len, base, base - ring)
    return torch.where(pos >= 0, pos, -1)


def _ring_window_attend(q, ck, cv, kpos_abs, q_offset, cfg):
    """Plain attention of S queries at ``q_offset`` over a ring cache whose
    slots hold the absolute positions ``kpos_abs`` (ring,): keys in
    ``(qpos - window, qpos]`` that were written.  The scalar-position
    decode of a ring cache (every row at the same length)."""
    B, S, H, hd = q.shape
    KV = ck.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    qpos = q_offset + torch.arange(S, device=q.device)
    mask = ((kpos_abs[None, :] <= qpos[:, None])
            & (kpos_abs[None, :] > qpos[:, None] - cfg.window)
            & (kpos_abs[None, :] >= 0))
    out = attn_lib._sdpa(qg, ck.to(q.dtype), cv.to(q.dtype), mask,
                         cfg.head_dim ** -0.5)
    return out.reshape(B, S, H, hd)


def _block(x, bp, cfg, *, moe, **attn_kw):
    """One block; returns (x, its MoE aux (0.0 for a dense block), the
    second output of ``_attn_forward``)."""
    h, cache = _attn_forward(apply_norm(x, bp["ln1"], cfg.norm), bp["attn"],
                             cfg, **attn_kw)
    x = x + h
    hin = apply_norm(x, bp["ln2"], cfg.norm)
    if moe:
        h, aux = moe_lib.moe_mlp(hin, bp["moe"], cfg)
    else:
        h, aux = ffn_lib.mlp(hin, bp["mlp"], cfg.act), 0.0
    return x + h, aux, cache


def _rope(cfg, positions, dtype):
    """The (cos, sin) table every layer turns q and k by at ``positions``
    (B, S): MLA's at qk_rope_dim, fully; standard RoPE's at head_dim and
    ``cfg.rope_fraction``; M-RoPE's at head_dim over (3, B, S) positions
    (the t, h and w streams; (B, S) ones become three equal streams, as
    the reference's serving routes build them); None without RoPE."""
    if cfg.mla:
        return rope_lib.rope_tables(positions, cfg.qk_rope_dim,
                                    theta=cfg.rope_theta, dtype=dtype)
    if cfg.rope == "standard":
        return rope_lib.rope_tables(positions, cfg.head_dim,
                                    theta=cfg.rope_theta,
                                    fraction=cfg.rope_fraction, dtype=dtype)
    if cfg.rope == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return rope_lib.mrope_tables(positions, cfg.head_dim,
                                     theta=cfg.rope_theta,
                                     sections=cfg.mrope_sections, dtype=dtype)
    return None


def _run_group(x, group, n, cfg, *, moe, rope, cache=None, **attn_kw):
    """A Python loop over a stacked group's ``n`` layers; layer ``i``
    reads and writes ``cache[...][i]`` views in place.  Returns (x, [each
    layer's second output of _attn_forward], the group's MoE aux sum)."""
    per_layer, aux_total = [], 0.0
    for i in range(n):
        layer_cache = None if cache is None else {
            name: leaf[i] for name, leaf in cache.items()}
        x, aux, second = _block(x, take_layer(group, i), cfg, moe=moe,
                                rope=rope, cache=layer_cache, **attn_kw)
        aux_total = aux_total + aux
        per_layer.append(second)
    return x, per_layer, aux_total


def _layer_stack(x, params, cfg, positions, cache=None, **attn_kw):
    """The block groups (``_groups``), each through ``_run_group``.
    ``positions`` (B, S) (or M-RoPE's (3, B, S)) are the tokens' absolute
    positions, which RoPE and MLA configs rotate by (one table for every
    layer; ignored without RoPE).  Returns the residual stream before the
    final norm, ``{cache key: [each layer's second output of
    _attn_forward]}`` (its cache, or its pending chunk K/V or latents) and
    the sum of the MoE layers' aux losses (0.0 without MoE layers)."""
    rope = _rope(cfg, positions, x.dtype)
    per_group, aux_total = {}, 0.0
    for key, ckey, moe, n in _groups(cfg):
        x, per_group[ckey], aux = _run_group(
            x, params[key], n, cfg, moe=moe, rope=rope,
            cache=None if cache is None else cache[ckey], **attn_kw)
        aux_total = aux_total + aux
    return x, per_group, aux_total


def _run_layers(x, params, cfg, positions, cache=None, **attn_kw):
    x, _, _ = _layer_stack(x, params, cfg, positions, cache=cache,
                           **attn_kw)
    return apply_norm(x, params["final_norm"], cfg.norm)


def _positions_from_batch(batch, x, cfg, q_offset=0):
    """Absolute positions of the embedded batch ``x``:
    ``batch["positions"]`` as given ((B, S), or M-RoPE's (3, B, S)), else
    ``q_offset + arange(S)`` on every row, (B, S) (``_rope`` makes three
    equal M-RoPE streams of it).  None without RoPE or MLA (nothing reads
    them)."""
    if cfg.rope not in ("standard", "mrope") and not cfg.mla:
        return None
    pos = batch.get("positions")
    if pos is not None:
        return pos
    B, S = x.shape[:2]
    return (q_offset + torch.arange(S, device=x.device))[None].expand(B, S)


# ================================================================== forward
def embed_inputs(params, batch, cfg):
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.continuous_inputs:
        x = batch["inputs"].to(cdt) @ params["in_proj"].to(cdt)
    else:
        x = params["embed"].to(cdt)[batch["tokens"].long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    if cfg.head == "cls":
        cls = params["cls_token"].to(cdt).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
    S = x.shape[1]
    if cfg.learned_pos:
        pos = batch.get("positions")
        if pos is None or pos.dim() != 2:
            pos = torch.arange(S, device=x.device)[None, :]
        # out-of-range positions clamp, as the reference's gather does
        pos = pos.long().clamp(0, cfg.learned_pos - 1)
        x = x + params["pos_embed"].to(cdt)[pos]
    return x


def forward(params, batch, cfg):
    """Full forward, plain attention throughout.
    batch: {"tokens": (B,S)} or {"inputs": (B,S,Din)}.
    Returns (logits, aux) with aux = {"moe_aux": the MoE layers' summed
    aux loss} (0.0 when the config has no MoE layers), plus
    ``"mtp_logits"`` (B, S - 1, V) where the config has an MTP head."""
    x = embed_inputs(params, batch, cfg)
    positions = _positions_from_batch(batch, x, cfg)
    x, _, moe_aux = _layer_stack(x, params, cfg, positions)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    aux = {"moe_aux": moe_aux}
    if cfg.mtp and "mtp" in params and not cfg.continuous_inputs:
        aux["mtp_logits"] = _mtp_forward(params, x, batch, positions, cfg)
    return _head(params, x, cfg), aux


def _mtp_forward(params, h, batch, positions, cfg):
    """DeepSeek-V3's depth-1 multi-token prediction head: position t's
    final hidden state (normed) beside token t + 1's embedding (normed),
    projected to d_model, through one dense block at positions[..., :-1],
    then the LM head (no final norm).  Its logits at t predict token t +
    2: (B, S - 1, V)."""
    mp = params["mtp"]
    cdt = h.dtype
    emb = params["embed"].to(cdt)[batch["tokens"].long()]
    hh = apply_norm(h[:, :-1], mp["norm_h"], cfg.norm)
    ee = apply_norm(emb[:, 1:], mp["norm_e"], cfg.norm)
    z = torch.cat([hh, ee], -1) @ mp["proj"].to(cdt)
    pos = None if positions is None else positions[..., :-1]
    z, _, _ = _run_group(z, mp["block"], 1, cfg, moe=False,
                         rope=_rope(cfg, pos, cdt) if pos is not None
                         else None)
    return _head(params, z, cfg)


def _head(params, x, cfg):
    cdt = x.dtype
    if cfg.head == "none":
        return x
    if cfg.head == "cls":
        return x[:, 0] @ params["head"].to(cdt)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w.to(cdt)


# ============================================================== serve (KV)
def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """{group: {"k", "v": (L_g, B, pad_cache_len(n), KV, hd)}} zeros for
    each block group (``"dense"`` and/or ``"moe"``), n = max_len, or
    min(max_len, window) with a window.  The cache axis keeps the
    reference pool's padding: a full layout masks the padded tail by each
    row's valid length, a ring takes the padded length as its modulus.
    MLA's groups hold the latents instead, {"ckv": (L_g, B, flen,
    kv_lora_rank), "kr": (L_g, B, flen, qk_rope_dim)}, flen =
    pad_cache_len(max_len) (no ring layout)."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    n = min(max_len, cfg.window) if cfg.window else max_len
    cache = {}
    for _, ckey, _, layers in _groups(cfg):
        if cfg.mla:
            lead = (layers, batch_size, pad_cache_len(max_len))
            cache[ckey] = {
                "ckv": torch.zeros((*lead, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "kr": torch.zeros((*lead, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)}
            continue
        shape = (layers, batch_size, pad_cache_len(n), cfg.n_kv_heads,
                 cfg.head_dim)
        cache[ckey] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache


def _forward_cached(params, batch, cfg, cache, q_offset, at=None,
                    **attn_kw):
    """Cached forward from ``q_offset``.  ``at`` (B,) picks one position
    per row whose logits are returned as (B, V); None returns (B, S, V)."""
    x = embed_inputs(params, batch, cfg)
    x = _run_layers(x, params, cfg,
                    _positions_from_batch(batch, x, cfg, q_offset),
                    cache=cache, q_offset=q_offset, **attn_kw)
    if at is not None:
        x = x[torch.arange(x.shape[0], device=x.device), at]
    return _head(params, x, cfg), cache


def prefill(params, batch, cfg, cache):
    """Run the prompt through the model, filling the cache in place.
    Returns (last-position logits (B, V), cache)."""
    B, S = batch["tokens"].shape
    last = torch.full((B,), S - 1, dtype=torch.long,
                      device=batch["tokens"].device)
    return _forward_cached(params, batch, cfg, cache, 0, at=last)


def decode_step(params, tokens, pos, cache, cfg):
    """One decode step. tokens: (B,) int; pos: int (current length).
    Returns (logits (B, V), cache)."""
    batch = {"tokens": tokens[:, None]}
    if cfg.learned_pos:
        # absolute learned positions track the decode offset
        batch["positions"] = torch.full((tokens.shape[0], 1), pos,
                                        dtype=torch.long,
                                        device=tokens.device)
    # every layer's attention reads the first pos + 1 positions of each row
    kv_len = torch.full((tokens.shape[0],), pos + 1, dtype=torch.int32,
                        device=tokens.device)
    logits, cache = _forward_cached(params, batch, cfg, cache, pos,
                                    decode_kv_len=kv_len)
    return logits[:, -1], cache


def prefill_full(params, batch, cfg, cache):
    """Prefill returning logits at EVERY prompt position: (B, S, V).
    ``batch["plens"]`` (true prompt lengths of bucket-padded rows) fills a
    ring cache per row; full caches hide the pad tail behind each row's
    valid length and ignore it."""
    plens = batch.get("plens")
    batch = {k: v for k, v in batch.items() if k != "plens"}
    return _forward_cached(params, batch, cfg, cache, 0, plens=plens)


def prefill_last(params, tokens, plens, cfg, cache):
    """Admission prefill: logits only at each row's true last prompt
    position, (B, V) -- the rows ``prefill_full`` would be gathered at,
    without the (B, S, V) logits tensor."""
    return _forward_cached(params, {"tokens": tokens}, cfg, cache, 0,
                           at=plens.long() - 1, plens=plens)


def decode_step_slots(params, tokens, positions, cache, cfg, done=None):
    """Continuous-batching decode: one token per slot at per-slot lengths.

    tokens: (B,) -- each slot's last token; positions: (B,) -- each slot's
    current length (this step's write position); done: optional (B,) bool
    -- finished/idle rows attend with kv_len == 0 (exact-zero attention).
    Returns (logits (B, V), cache) with the cache updated in place.
    """
    batch = {"tokens": tokens[:, None], "positions": positions[:, None]}
    # RoPE turns at the unclamped position; only the cache write clamps
    x = _run_layers(embed_inputs(params, batch, cfg), params, cfg,
                    batch["positions"], cache=cache,
                    slot_positions=positions.long(),
                    slot_kv_len=_slot_kv_len(positions, done).to(torch.int32),
                    slot_done=done)
    return _head(params, x, cfg)[:, -1], cache


def prefill_cache(params, tokens, cfg, cache, plens=None):
    """Admission prefill that only fills the cache (no final norm, no
    head): a speculative draft's admission, whose logits nobody reads.
    ``plens`` fills a ring cache per row (a full cache hides each row's
    pad tail behind its length).  Returns the cache, updated in place."""
    batch = {"tokens": tokens}
    x = embed_inputs(params, batch, cfg)
    _layer_stack(x, params, cfg, _positions_from_batch(batch, x, cfg),
                 cache=cache, q_offset=0, plens=plens)
    return cache


def verify_step_slots(params, tokens, positions, cache, cfg, done=None,
                      logits=True):
    """Speculative verify: feed an (B, S) token chunk per slot, each row
    starting at its own committed length ``positions[b]``, in ONE batched
    forward.

    Returns (logits (B, S, V), pending): ``logits[:, j]`` is the
    distribution after each row consumed its chunk prefix ``[:j + 1]``.
    The slot cache is READ-ONLY here; ``pending`` = {group: {"k", "v":
    (L_g, B, S, KV, hd)}} (MLA: {"ckv", "kr": (L_g, B, S, r)}) carries
    the chunk's per-layer K/V or latents so that ``commit_slots`` writes
    exactly the accepted prefix afterwards
    (rollback is "never wrote it").  ``done`` rows attend nothing and
    return garbage logits the caller must mask.  ``logits=False`` skips
    the final norm and the head and returns (None, pending): a draft's
    catch-up needs only its pending K/V.
    """
    B, S = tokens.shape
    # learned positions past the table clamp in ``embed_inputs``; such
    # overshot positions are never committed (budget-masked)
    pos2d = positions[:, None] + torch.arange(
        S, dtype=positions.dtype, device=positions.device)[None]
    x = embed_inputs(params, {"tokens": tokens, "positions": pos2d}, cfg)
    # RoPE turns at the unclamped positions, overshoot included
    x, per_group, _ = _layer_stack(x, params, cfg, pos2d, cache=cache,
                                   chunk_offsets=positions, slot_done=done)
    pending = {ckey: {name: torch.stack([pl[name] for pl in per_layer])
                      for name in per_layer[0]}
               for ckey, per_layer in per_group.items()}
    if not logits:
        return None, pending
    return _head(params, apply_norm(x, params["final_norm"], cfg.norm),
                 cfg), pending


def commit_slots(params, tokens, positions, n_feed, cache, pending, cfg,
                 done=None):
    """Commit each row's accepted chunk prefix: the pending K/V of chunk
    indices ``j < n_feed[b]`` go to ``positions[b] + j``; the rest is
    dropped, so rejected speculative positions never reach the cache.
    Rows with ``n_feed == 0`` (or ``done``) keep their pool rows
    bit-for-bit.  A ring writes position ``pos`` at slot ``pos % ring``
    (a chunk fits the ring, ``spec_pair_supported``, so no slot is
    written twice); in a full layout committed positions lie inside the
    cache (the engine's ``max_len`` bound keeps them below it).

    The reference scatters uncommitted entries to an out-of-range index
    and lets the scatter drop them; PyTorch refuses such an index (on the
    card, a device-side assert).  Dense pool: every chunk entry j writes
    the committed entry ``min(j, n_feed - 1)`` again -- the same value at
    the same place -- and a row with nothing to commit writes back the
    old value of its position ``positions[b]`` (clamped into the cache,
    or at its ring slot).  Paged pool: slot ``s`` resolves to page
    ``bt[b, s // page]`` and an uncommitted entry goes to the scratch page
    (``serve/paged.py``).  No boolean-mask indexing and no host sync
    either way.
    """
    del params, tokens
    if done is not None:
        n_feed = torch.where(done, 0, n_feed)
    n_feed = n_feed.long()
    for ckey, group in cache.items():
        if "bt" in group:
            _commit_paged(group, pending[ckey], positions, n_feed,
                          cfg.window)
        else:
            _commit_dense(group, pending[ckey], positions, n_feed,
                          cfg.window)
    return cache


def _commit_dense(group, pending, positions, n_feed, window):
    """``commit_slots`` for a dense group of (L, B, Sc, ...) leaves ("k"/
    "v", or MLA's "ckv"/"kr"); pending leaves are (L, B, S, ...)."""
    for name, cl in group.items():
        pl = pending[name]
        B, Sc = cl.shape[1], cl.shape[2]
        S = pl.shape[2]
        steps = torch.arange(S, device=cl.device)[None]
        src = torch.minimum(steps, (n_feed - 1).clamp(min=0)[:, None])
        idx = positions.long()[:, None] + src
        idx = idx % Sc if _is_ring(Sc, window) else idx.clamp(max=Sc - 1)
        rows = torch.arange(B, device=cl.device)[:, None]
        keep = (n_feed > 0).view(1, B, *([1] * (cl.dim() - 2)))
        new = torch.where(keep, pl[:, rows, src].to(cl.dtype),
                          cl[:, rows, idx])
        cl[:, rows, idx] = new


def _commit_paged(group, pending, positions, n_feed, window):
    """``commit_slots`` for a paged group {arenas (L, n_pages + 1, page,
    ...), "bt": (L, B, nblk)}: K/V arenas, or MLA's latent ones; pending
    leaves are (L, B, S, ...) and never carry a table.  Entry j of row b,
    at position pos = positions[b] + j, goes to slot s = pos (a ring: pos
    % (nblk * page)) on page ``bt[b, s // page]``, or to the scratch page
    when it is not committed (or lies past the table)."""
    bt = group["bt"][0]  # layers share one table
    leaves = [name for name in group if name != "bt"]
    n_pages, page = group[leaves[0]].shape[1] - 1, group[leaves[0]].shape[2]
    nblk = bt.shape[1]
    S = pending[leaves[0]].shape[2]
    steps = torch.arange(S, device=bt.device)[None]
    pos = positions.long()[:, None] + steps  # (B, S)
    if _is_ring(nblk * page, window):
        pos = pos % (nblk * page)
    blk = pos // page
    pid = bt.gather(1, blk.clamp(max=nblk - 1)).long()
    keep = (steps < n_feed[:, None]) & (blk < nblk)
    pid = torch.where(keep, pid, n_pages)
    off = pos % page
    for name in leaves:
        arena = group[name]
        arena[:, pid, off] = pending[name].to(arena.dtype)


def serve_supported(cfg):
    """Capability probe for the continuous-batching slot protocol.
    Returns (ok, detail): the slot cache layout, or why not."""
    if not cfg.causal or cfg.continuous_inputs:
        return False, ("requires a causal token LM "
                       f"(causal={cfg.causal}, "
                       f"continuous_inputs={cfg.continuous_inputs})")
    if cfg.mla and cfg.window:
        return False, "MLA latent caches have no ring-buffer window layout"
    if cfg.mla:
        return True, "full MLA latent cache (O(max_len) per slot)"
    if cfg.window:
        return True, "ring-buffer window KV cache (O(window) per slot)"
    return True, "full KV cache (O(max_len) per slot)"


def paged_groups(cfg):
    """Slot-state protocol: the cache groups that page under a paged pool,
    ``{key: (kind, leaf names)}``.  Every block group ("dense", "moe")
    pages on its sequence axis: its K/V, or MLA's latents ("ckv", "kr");
    the groups share one block table layout."""
    leaves = ("ckv", "kr") if cfg.mla else ("k", "v")
    return {ckey: ("seq", leaves) for _, ckey, _, _ in _groups(cfg)}


def slot_cache_layout(cfg):
    """Slot-pool layout tag for telemetry: "full", "ring" (a window), or
    "full-mla" (MLA's latent cache)."""
    if not serve_supported(cfg)[0]:
        return "unsupported"
    if cfg.mla:
        return "full-mla"
    return "ring" if cfg.window else "full"


# ------------------------------------------------------------ speculation
def snapshot_slots(cache, positions, n):
    """What a run of ``n`` slot-decode steps from ``positions`` overwrites
    in a ring cache: the ring bytes at the sites ``(positions + j) %
    ring`` it writes (``spec_ring_sites``, through the block table on a
    paged pool).  The speculative loop asks for it only for a windowed
    draft (``slot_cache_layout`` "ring"); a full layout's steps write only
    past each row's committed length.  A speculative draft takes one
    before it proposes in place and ``restore_slots`` puts it back, so its
    catch-up verify reads the committed ring (the reference proposes on a
    copy).  One snapshot per cache group: {group key: sites}."""
    return {ckey: (paged_spec_ring_sites if "bt" in grp
                   else spec_ring_sites)(grp, positions, n)
            for ckey, grp in cache.items()}


def restore_slots(cache, snap, positions, n):
    """Put the ring sites of ``snapshot_slots`` back in place (every one
    of the ``n`` steps rejected), group by group.  Returns the cache."""
    for ckey, grp in cache.items():
        restore = (paged_spec_ring_restore if "bt" in grp
                   else spec_ring_restore)
        restore(snap[ckey], grp, positions, torch.zeros_like(positions), n)
    return cache
