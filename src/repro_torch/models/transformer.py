"""Transformer family, ported for dense decoder LMs.

Covers the paper's GPT/BERT/DeiT configs and the RoPE decoders (qwen1.5,
qwen3, stablelm, yi): LayerNorm or RMSNorm, GELU or gated MLPs, learned
absolute positions or standard (optionally partial) RoPE, qkv bias and
per-head q/k norms, MHA or GQA attention, separate or tied LM head.
Params are nested dicts stacked over a leading layer axis, as in the
reference package.  Configs with MLA, MoE, a sliding window, multimodal
RoPE or an MTP head raise ``NotImplementedError`` (ROADMAP.md lists the
slices that bring them).

RoPE rotates q and k after the q/k norms and before any cache write, at
each token's absolute position: ``q_offset + arange(S)`` on the scalar
routes (or ``batch["positions"]``), each slot's own, unclamped position on
the slot routes, and ``positions[b] + arange(S)`` in speculative verify.
One (cos, sin) table per forward serves every layer.

Four call sites reach the hand-written kernels through ``kernels.ops``,
which picks kernel or plain version by the tensor's device:
  * causal cached prefill at ``q_offset == 0`` -> ``ops.flash_attention``
    (the kernel masks ragged tiles, so every prefill length takes it);
  * the scalar cached decode step (``decode_step``: S == 1 at one shared
    position) -> ``ops.decode_attention`` over the cache's head-major
    ``transpose(1, 2)`` view (strides, no copy);
  * continuous-batching slot decode -> ``ops.slot_decode_attention``, or
    ``ops.paged_slot_decode_attention`` over a paged pool;
  * speculative verify of a chunk per slot -> ``ops.chunk_verify_attention``
    or ``ops.paged_chunk_verify_attention`` (``verify_step_slots``;
    ``commit_slots`` then writes the accepted prefix).
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
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import (
    apply_norm,
    init_norm,
    pad_cache_len,
    rms_norm,
    take_layer,
    trunc_normal,
)
from repro_torch.utils.pytree import tree_map


def _unported(cfg):
    """The reason this config is outside the ported slice, or None."""
    if cfg.family != "transformer":
        return f"family {cfg.family!r}"
    for flag, what in ((cfg.mla, "MLA attention"), (cfg.moe, "MoE layers"),
                       (cfg.window, "sliding-window attention"),
                       (cfg.mtp, "the MTP head"),
                       (cfg.rope not in ("none", "standard"),
                        f"RoPE ({cfg.rope})")):
        if flag:
            return what
    return None


def _require_ported(cfg):
    why = _unported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported to repro_torch yet (see "
            "ROADMAP.md, queue 1, for the slice that brings it)")


# =============================================================== param init
def _attn_init(gen, cfg, layers, dtype, std, device):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    zeros = dict(dtype=dtype, device=device)

    def w(*shape):
        return trunc_normal(gen, shape, std, dtype, device)

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
    _require_ported(cfg)
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
    L = cfg.n_layers
    params["dense_blocks"] = {
        "ln1": init_norm(cfg.norm, D, L, dtype, device),
        "ln2": init_norm(cfg.norm, D, L, dtype, device),
        "attn": _attn_init(gen, cfg, L, dtype, std, device),
        "mlp": ffn_lib.init_mlp(gen, D, cfg.d_ff, layers=L, act=cfg.act,
                                bias=cfg.mlp_bias, dtype=dtype, std=std,
                                device=device),
    }
    params["final_norm"] = init_norm(cfg.norm, D, None, dtype, device)
    if cfg.head == "lm" and not cfg.tie_embeddings:
        params["head"] = w(D, cfg.vocab_size)
    elif cfg.head == "cls":
        params["cls_token"] = w(D)
        params["head"] = w(D, cfg.n_classes)
    return params


def param_shapes(cfg) -> dict:
    """``init``'s tree with a ``torch.Size`` at every leaf, computed on the
    meta device: nothing is drawn or allocated (the reference package's
    ``jax.eval_shape`` of ``init``)."""
    params = init(torch.Generator(), cfg, device="meta")
    return tree_map(lambda t: t.shape, params)


# ============================================================ forward pieces
def _slot_kv_len(slot_positions, slot_done):
    """Per-row valid cache length for the slot-decode path; finished or
    idle rows (``slot_done``) get 0, so the kernel skips their reads."""
    kv = slot_positions + 1
    if slot_done is None:
        return kv
    return torch.where(slot_done, 0, kv)


def _cache_seq_len(cache):
    """Logical sequence length of a slot cache group: the cache axis of the
    dense layout, ``nblk * page`` through the block table of a paged group
    (whose arenas carry no per-slot sequence axis)."""
    if "bt" in cache:
        return cache["bt"].shape[-1] * cache["k"].shape[-3]
    return cache["k"].shape[-3]


def _paged_slot_forward(q, cache, k, v, slot_positions, slot_kv_len,
                        slot_done, cdt):
    """Slot-decode step over one layer of a PAGED cache group.

    cache: {"k"/"v": (n_pages + 1, page, KV, hd), "bt": (B, nblk)}.  The
    write of row b resolves through its table: page ``bt[b, pos // page]``
    at offset ``pos % page``.  A write that must be dropped -- a ``done``
    row (whose table may be all-sentinel after eviction), a position past
    the row's pages (its table entry is the sentinel) or at or past
    ``nblk * page`` -- goes to the scratch page ``n_pages``, which no read
    sees (``serve/paged.py``).  Reads go to the paged slot kernel over the
    real pages only.  Returns (B, 1, H, hd).
    """
    ck, cv, bt = cache["k"], cache["v"], cache["bt"]
    n_pages, page = ck.shape[0] - 1, ck.shape[1]
    nblk = bt.shape[1]
    blk = slot_positions // page
    pid = bt.gather(1, blk.clamp(max=nblk - 1)[:, None])[:, 0].long()
    drop = slot_positions >= _cache_seq_len(cache)
    if slot_done is not None:
        drop = drop | slot_done
    pid = torch.where(drop, n_pages, pid)
    off = slot_positions % page
    ck[pid, off] = k[:, 0].to(ck.dtype)
    cv[pid, off] = v[:, 0].to(cv.dtype)
    out = ops.paged_slot_decode_attention(
        q[:, 0], ck[:n_pages].to(cdt), cv[:n_pages].to(cdt), bt, slot_kv_len)
    return out[:, None]


def _attn_forward(x, p, cfg, *, rope=None, cache=None, q_offset=0,
                  slot_positions=None, slot_kv_len=None, chunk_offsets=None,
                  slot_done=None, decode_kv_len=None):
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
    """
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

    if chunk_offsets is not None:
        # the pool leaves as they are: no [cache ‖ chunk] copy
        if "bt" in cache:
            n_pages = cache["k"].shape[0] - 1  # the scratch page stays unread
            out = ops.paged_chunk_verify_attention(
                q, cache["k"][:n_pages].to(cdt), cache["v"][:n_pages].to(cdt),
                cache["bt"], k, v, chunk_offsets, ring=False, done=slot_done)
        else:
            out = ops.chunk_verify_attention(q, cache["k"].to(cdt),
                                             cache["v"].to(cdt), k, v,
                                             chunk_offsets, ring=False,
                                             done=slot_done)
        return _attn_out(out, p, cfg, cdt), {"k": k, "v": v}
    if slot_positions is not None and "bt" in cache:
        out = _paged_slot_forward(q, cache, k, v, slot_positions,
                                  slot_kv_len, slot_done, cdt)
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
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, q_offset:q_offset + S] = k.to(ck.dtype)
        cv[:, q_offset:q_offset + S] = v.to(cv.dtype)
        k, v = ck.to(cdt), cv.to(cdt)
        kv_len = q_offset + S
        if S > 1 and cfg.causal and q_offset == 0:
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
    out = attn_lib.attention(q, k, v, causal=cfg.causal, q_offset=q_offset,
                             kv_len=kv_len, chunk_q=cfg.attn_chunk)
    return _attn_out(out, p, cfg, cdt), cache


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


def _block(x, bp, cfg, **attn_kw):
    h, cache = _attn_forward(apply_norm(x, bp["ln1"], cfg.norm), bp["attn"],
                             cfg, **attn_kw)
    x = x + h
    x = x + ffn_lib.mlp(apply_norm(x, bp["ln2"], cfg.norm), bp["mlp"],
                        cfg.act)
    return x, cache


def _layer_stack(x, params, cfg, positions, cache=None, **attn_kw):
    """The block stack as a Python loop over the stacked layer axis; layer
    ``i`` reads and writes ``cache[...][i]`` views in place.  ``positions``
    (B, S) are the tokens' absolute positions, which RoPE configs rotate
    by (one table for every layer; ignored without RoPE).  Returns the
    residual stream before the final norm and each layer's second output
    of ``_attn_forward`` (its cache, or its pending chunk K/V)."""
    rope = None
    if cfg.rope == "standard":
        rope = rope_lib.rope_tables(positions, cfg.head_dim,
                                    theta=cfg.rope_theta,
                                    fraction=cfg.rope_fraction,
                                    dtype=x.dtype)
    group = params["dense_blocks"]
    per_layer = []
    for i in range(cfg.n_layers):
        layer_cache = None if cache is None else {
            name: leaf[i] for name, leaf in cache["dense"].items()}
        x, second = _block(x, take_layer(group, i), cfg, rope=rope,
                           cache=layer_cache, **attn_kw)
        per_layer.append(second)
    return x, per_layer


def _run_layers(x, params, cfg, positions, cache=None, **attn_kw):
    x, _ = _layer_stack(x, params, cfg, positions, cache=cache, **attn_kw)
    return apply_norm(x, params["final_norm"], cfg.norm)


def _positions_from_batch(batch, x, cfg, q_offset=0):
    """(B, S) absolute positions of the embedded batch ``x``:
    ``batch["positions"]`` where given, else ``q_offset + arange(S)`` on
    every row.  None without RoPE (nothing reads them)."""
    if cfg.rope != "standard":
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
    Returns (logits, aux) with aux = {"moe_aux": 0.0}."""
    _require_ported(cfg)
    x = embed_inputs(params, batch, cfg)
    x = _run_layers(x, params, cfg, _positions_from_batch(batch, x, cfg))
    return _head(params, x, cfg), {"moe_aux": 0.0}


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
    """{"dense": {"k", "v": (L, B, pad_cache_len(max_len), KV, hd)}} zeros.
    The cache axis keeps the reference pool's padding; the padded tail is
    masked by each row's valid length."""
    _require_ported(cfg)
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    shape = (cfg.n_layers, batch_size, pad_cache_len(max_len),
             cfg.n_kv_heads, cfg.head_dim)
    return {"dense": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _forward_cached(params, batch, cfg, cache, q_offset, at=None,
                    **attn_kw):
    """Cached forward from ``q_offset``.  ``at`` (B,) picks one position
    per row whose logits are returned as (B, V); None returns (B, S, V)."""
    _require_ported(cfg)
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
    ``batch["plens"]`` (true prompt lengths of bucket-padded rows) is
    accepted and ignored: full caches hide the pad tail behind each row's
    valid length."""
    batch = {k: v for k, v in batch.items() if k != "plens"}
    return _forward_cached(params, batch, cfg, cache, 0)


def prefill_last(params, tokens, plens, cfg, cache):
    """Admission prefill: logits only at each row's true last prompt
    position, (B, V) -- the rows ``prefill_full`` would be gathered at,
    without the (B, S, V) logits tensor."""
    return _forward_cached(params, {"tokens": tokens}, cfg, cache, 0,
                           at=plens.long() - 1)


def decode_step_slots(params, tokens, positions, cache, cfg, done=None):
    """Continuous-batching decode: one token per slot at per-slot lengths.

    tokens: (B,) -- each slot's last token; positions: (B,) -- each slot's
    current length (this step's write position); done: optional (B,) bool
    -- finished/idle rows attend with kv_len == 0 (exact-zero attention).
    Returns (logits (B, V), cache) with the cache updated in place.
    """
    _require_ported(cfg)
    batch = {"tokens": tokens[:, None], "positions": positions[:, None]}
    # RoPE turns at the unclamped position; only the cache write clamps
    x = _run_layers(embed_inputs(params, batch, cfg), params, cfg,
                    batch["positions"], cache=cache,
                    slot_positions=positions.long(),
                    slot_kv_len=_slot_kv_len(positions, done).to(torch.int32),
                    slot_done=done)
    return _head(params, x, cfg)[:, -1], cache


def prefill_cache(params, tokens, cfg, cache):
    """Admission prefill that only fills the cache (no final norm, no
    head): a speculative draft's admission, whose logits nobody reads.
    Returns the cache, updated in place."""
    _require_ported(cfg)
    batch = {"tokens": tokens}
    x = embed_inputs(params, batch, cfg)
    _layer_stack(x, params, cfg, _positions_from_batch(batch, x, cfg),
                 cache=cache, q_offset=0)
    return cache


def verify_step_slots(params, tokens, positions, cache, cfg, done=None,
                      logits=True):
    """Speculative verify: feed an (B, S) token chunk per slot, each row
    starting at its own committed length ``positions[b]``, in ONE batched
    forward.

    Returns (logits (B, S, V), pending): ``logits[:, j]`` is the
    distribution after each row consumed its chunk prefix ``[:j + 1]``.
    The slot cache is READ-ONLY here; ``pending`` = {"dense": {"k", "v":
    (L, B, S, KV, hd)}} carries the chunk's per-layer K/V so that
    ``commit_slots`` writes exactly the accepted prefix afterwards
    (rollback is "never wrote it").  ``done`` rows attend nothing and
    return garbage logits the caller must mask.  ``logits=False`` skips
    the final norm and the head and returns (None, pending): a draft's
    catch-up needs only its pending K/V.
    """
    _require_ported(cfg)
    B, S = tokens.shape
    # learned positions past the table clamp in ``embed_inputs``; such
    # overshot positions are never committed (budget-masked)
    pos2d = positions[:, None] + torch.arange(
        S, dtype=positions.dtype, device=positions.device)[None]
    x = embed_inputs(params, {"tokens": tokens, "positions": pos2d}, cfg)
    # RoPE turns at the unclamped positions, overshoot included
    x, per_layer = _layer_stack(x, params, cfg, pos2d, cache=cache,
                                chunk_offsets=positions, slot_done=done)
    pending = {"dense": {name: torch.stack([pl[name] for pl in per_layer])
                         for name in ("k", "v")}}
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
    bit-for-bit.  Full layouts only; committed positions must lie inside
    the cache (the engine's ``max_len`` bound keeps them below it).

    The reference scatters uncommitted entries to an out-of-range index
    and lets the scatter drop them; PyTorch refuses such an index (on the
    card, a device-side assert).  Dense pool: every chunk entry j writes
    the committed entry ``min(j, n_feed - 1)`` again -- the same value at
    the same place -- and a row with nothing to commit writes back the
    old value of its position ``positions[b]`` (clamped into the cache).
    Paged pool: position ``pos`` resolves to page ``bt[b, pos // page]``
    and an uncommitted entry goes to the scratch page (``serve/paged.py``).
    No boolean-mask indexing and no host sync either way.
    """
    del params, tokens
    if done is not None:
        n_feed = torch.where(done, 0, n_feed)
    n_feed = n_feed.long()
    group = cache["dense"]
    if "bt" in group:
        _commit_paged(group, pending["dense"], positions, n_feed)
        return cache
    for name, cl in group.items():
        pl = pending["dense"][name]  # (L, B, S, KV, hd)
        B, Sc = cl.shape[1], cl.shape[2]
        S = pl.shape[2]
        steps = torch.arange(S, device=cl.device)[None]
        src = torch.minimum(steps, (n_feed - 1).clamp(min=0)[:, None])
        idx = (positions.long()[:, None] + src).clamp(max=Sc - 1)
        rows = torch.arange(B, device=cl.device)[:, None]
        new = torch.where((n_feed > 0)[None, :, None, None, None],
                          pl[:, rows, src].to(cl.dtype), cl[:, rows, idx])
        cl[:, rows, idx] = new
    return cache


def _commit_paged(group, pending, positions, n_feed):
    """``commit_slots`` for a paged group {arenas (L, n_pages + 1, page,
    KV, hd), "bt": (L, B, nblk)}; pending leaves are (L, B, S, KV, hd) and
    never carry a table.  Entry j of row b goes to page ``bt[b, (pos + j)
    // page]``, or to the scratch page when it is not committed (or lies
    past the table)."""
    bt = group["bt"][0]  # layers share one table
    n_pages, page = group["k"].shape[1] - 1, group["k"].shape[2]
    nblk = bt.shape[1]
    S = pending["k"].shape[2]
    steps = torch.arange(S, device=bt.device)[None]
    pos = positions.long()[:, None] + steps  # (B, S)
    blk = pos // page
    pid = bt.gather(1, blk.clamp(max=nblk - 1)).long()
    keep = (steps < n_feed[:, None]) & (blk < nblk)
    pid = torch.where(keep, pid, n_pages)
    off = pos % page
    for name in ("k", "v"):
        arena = group[name]
        arena[:, pid, off] = pending[name].to(arena.dtype)


def serve_supported(cfg):
    """Capability probe for the continuous-batching slot protocol.
    Returns (ok, detail): the slot cache layout, or why not."""
    if not cfg.causal or cfg.continuous_inputs:
        return False, ("requires a causal token LM "
                       f"(causal={cfg.causal}, "
                       f"continuous_inputs={cfg.continuous_inputs})")
    why = _unported(cfg)
    if why is not None:
        return False, (f"{why} is not ported to repro_torch yet (see "
                       "ROADMAP.md)")
    return True, "full KV cache (O(max_len) per slot)"


def paged_groups(cfg):
    """Slot-state protocol: the cache groups that page under a paged pool,
    ``{key: (kind, leaf names)}``.  The transformer's K/V group pages on
    its sequence axis; the port has no MoE or MLA groups yet."""
    _require_ported(cfg)
    return {"dense": ("seq", ("k", "v"))}


def slot_cache_layout(cfg):
    """Slot-pool layout tag for telemetry."""
    return "full" if serve_supported(cfg)[0] else "unsupported"
