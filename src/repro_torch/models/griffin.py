"""Griffin / RecurrentGemma family (arXiv:2402.19427), ported.

Block pattern 2 recurrent : 1 local-MQA attention.  The recurrent temporal
block is linear -> causal depthwise conv(4) -> RG-LRU, gated by a parallel
GeLU branch.  RG-LRU:

    r_t = sigmoid(W_a y_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_i y_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

A multi-token pass (forward, prefill) computes the gates for every
position and runs the recurrence through ``ops.rglru_scan`` (the CUDA
scan kernel on the card; the reference runs ``lax.associative_scan``).  A
single-token cached step runs it directly (``rglru_step``).  The local
attention keeps a ring-buffer window cache per slot; its slot-decode step
goes through ``ops.ring_decode_attention`` (dense pool) or
``ops.paged_ring_decode_attention`` (paged pool), and its prefill is plain
banded attention, as in the reference.

Caches are updated in place (the reference returns new buffers, which XLA
aliases through donation); the returned cache is the same dict.  The
speculative hooks (``verify_step_slots``, ``commit_slots``) are not
ported, so griffin serves greedy without speculation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.common import (
    apply_norm,
    freeze_rows,
    gelu,
    init_norm,
    pad_cache_len,
    take_layer,
    trunc_normal,
)
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import _ring_positions, _ring_window_attend

C_RGLRU = 8.0


def block_pattern(cfg):
    if cfg.block_pattern:
        return cfg.block_pattern
    # the recurrentgemma pattern: (rec, rec, attn) repeating
    return tuple("attn" if i % 3 == 2 else "rec" for i in range(cfg.n_layers))


def _counts(cfg):
    pat = block_pattern(cfg)
    n_rec = sum(1 for t in pat if t == "rec")
    return n_rec, len(pat) - n_rec


# ------------------------------------------------------------------- init
def init(gen: torch.Generator, cfg, device=None) -> dict:
    """Random params drawn from ``gen``, on ``device`` (default: the
    generator's device), in the reference's tree and layouts."""
    device = device or gen.device
    dtype = getattr(torch, cfg.param_dtype)
    std = 0.02
    D, W = cfg.d_model, cfg.lru_width
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_rec, n_attn = _counts(cfg)
    zeros = dict(dtype=dtype, device=device)

    def w(*shape):
        return trunc_normal(gen, shape, std, dtype, device)

    params = {"embed": w(cfg.vocab_size, D)}
    lam = torch.rand((n_rec, W), generator=gen, device=device) * 0.5 + 0.2
    params["rec_blocks"] = {
        "ln1": init_norm(cfg.norm, D, n_rec, dtype, device),
        "ln2": init_norm(cfg.norm, D, n_rec, dtype, device),
        "w_x": w(n_rec, D, W), "w_gate": w(n_rec, D, W),
        "w_out": w(n_rec, W, D), "conv_w": w(n_rec, cfg.conv_width, W),
        "conv_b": torch.zeros((n_rec, W), **zeros),
        # block-diagonal gate projections with n_heads blocks
        # (recurrentgemma's BlockDiagonalLinear)
        "w_a": w(n_rec, H, W // H, W // H),
        "b_a": torch.zeros((n_rec, W), **zeros),
        "w_i": w(n_rec, H, W // H, W // H),
        "b_i": torch.zeros((n_rec, W), **zeros),
        # Lambda so that a spans ~(0.9, 0.999), as in the paper
        "lam": lam.to(dtype),
        "mlp": ffn_lib.init_mlp(gen, D, cfg.d_ff, layers=n_rec, act=cfg.act,
                                dtype=dtype, std=std, device=device),
    }
    if n_attn:
        params["attn_blocks"] = {
            "ln1": init_norm(cfg.norm, D, n_attn, dtype, device),
            "ln2": init_norm(cfg.norm, D, n_attn, dtype, device),
            "wq": w(n_attn, D, H * hd), "wk": w(n_attn, D, KV * hd),
            "wv": w(n_attn, D, KV * hd), "wo": w(n_attn, H * hd, D),
            "mlp": ffn_lib.init_mlp(gen, D, cfg.d_ff, layers=n_attn,
                                    act=cfg.act, dtype=dtype, std=std,
                                    device=device),
        }
    params["final_norm"] = init_norm(cfg.norm, D, None, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = w(D, cfg.vocab_size)
    return params


# ------------------------------------------------------------------ RG-LRU
def _block_diag(yf, w):
    """Block-diagonal linear: yf (B, S, W), w (H, W/H, W/H) -> (B, S, W)."""
    B, S, W = yf.shape
    H = w.shape[0]
    yh = yf.reshape(B, S, H, W // H)
    return torch.einsum("bshw,hwv->bshv", yh, w.to(yf.dtype)).reshape(
        B, S, W)


def _rglru_gates(y, bp):
    """y: (B, S, W) post-conv activations -> (log_a, x_scaled), both f32."""
    yf = y.float()
    r = torch.sigmoid(_block_diag(yf, bp["w_a"]) + bp["b_a"].float())
    i = torch.sigmoid(_block_diag(yf, bp["w_i"]) + bp["b_i"].float())
    log_a = -C_RGLRU * F.softplus(bp["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * yf)
    return log_a, gated


def rglru_parallel(y, bp, h0=None, valid=None):
    """RG-LRU over the whole sequence. y: (B, S, W).

    ``h0``: optional (B, W) f32 initial state.  ``valid``: optional (B, S)
    bool; invalid positions (the padded tails of bucketed admission
    prompts) are frozen to a = 1, b = 0, so the recurrence carries h
    through them unchanged and the final state is exactly h at each row's
    last real position.  The recurrence runs in ``ops.rglru_scan``.
    Returns (h (B, S, W) in y's dtype, h_last (B, W) f32).
    """
    log_a, b = _rglru_gates(y, bp)
    if valid is not None:
        log_a = torch.where(valid[..., None], log_a, 0.0)
        b = torch.where(valid[..., None], b, 0.0)
    a = torch.exp(log_a)
    h = ops.rglru_scan(a, b, None if h0 is None else h0.float())
    return h.to(y.dtype), h[:, -1]


def rglru_step(y, h_prev, bp):
    """One RG-LRU step. y: (B, 1, W); h_prev: (B, W) f32."""
    log_a, b = _rglru_gates(y, bp)
    h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
    return h.to(y.dtype)[:, None], h


def _causal_conv(y, w, b, state=None, lengths=None):
    """Depthwise causal conv. y: (B, S, W); w: (K, W); state: (B, K-1, W)
    or None.  ``lengths`` (B,): each row's true length; the returned tail
    (the last K-1 inputs, the state decode continues from) is then
    gathered at each row's own boundary, not at the padded end."""
    K = w.shape[0]
    S = y.shape[1]
    if state is None:
        ypad = F.pad(y, (0, 0, K - 1, 0))
    else:
        ypad = torch.cat([state.to(y.dtype), y], dim=1)
    out = ypad[:, 0:S] * w[0].to(y.dtype)
    for k in range(1, K):
        out = out + ypad[:, k:k + S] * w[k].to(y.dtype)
    out = out + b.to(y.dtype)
    if K == 1:
        new_state = None
    elif lengths is None:
        new_state = ypad[:, -(K - 1):]
    else:
        # ypad row of position t is t + K - 1: row b's tail covers
        # positions lengths[b] - (K-1) .. lengths[b] - 1
        idx = lengths.long()[:, None] + torch.arange(K - 1,
                                                     device=y.device)[None]
        new_state = ypad.gather(1, idx[..., None].expand(-1, -1,
                                                         ypad.shape[2]))
    return out, new_state


def _rec_temporal(x, bp, cfg, conv_state=None, h_state=None, plens=None):
    """Recurrent temporal block.  Returns (out, new_conv_state, new_h).
    A single-token cached step takes ``rglru_step``; every multi-token
    call takes the scan.  ``plens`` marks a bucketed admission prefill."""
    y = x @ bp["w_x"].to(x.dtype)
    g = gelu(x @ bp["w_gate"].to(x.dtype))
    y, new_conv = _causal_conv(y, bp["conv_w"], bp["conv_b"], conv_state,
                               lengths=plens)
    if h_state is not None and y.shape[1] == 1:
        h, new_h = rglru_step(y, h_state, bp)
    else:
        valid = None
        if plens is not None:
            valid = (torch.arange(y.shape[1], device=y.device)[None]
                     < plens[:, None])
        h, new_h = rglru_parallel(y, bp, h0=h_state, valid=valid)
    return (h * g) @ bp["w_out"].to(x.dtype), new_conv, new_h


# ------------------------------------------------------------------ blocks
def _rec_block(x, bp, cfg, cache=None, plens=None, done=None):
    """cache: this layer's {"conv": (B, K-1, W), "h": (B, W)} views of the
    pool, written in place; ``done`` rows keep theirs bit for bit."""
    h, new_conv, new_h = _rec_temporal(
        apply_norm(x, bp["ln1"], cfg.norm), bp, cfg,
        conv_state=None if cache is None else cache["conv"],
        h_state=None if cache is None else cache["h"], plens=plens)
    x = x + h
    x = x + ffn_lib.mlp(apply_norm(x, bp["ln2"], cfg.norm), bp["mlp"],
                        cfg.act)
    if cache is not None:
        new = {"conv": new_conv, "h": new_h}
        if done is not None:
            new = freeze_rows(cache, new, done)
        for name, t in new.items():
            cache[name].copy_(t)
    return x


def _attn_block(x, bp, cfg, positions, cache=None, q_offset=0,
                slot_positions=None, slot_done=None, plens=None):
    B, S, _ = x.shape
    cdt = x.dtype
    xin = apply_norm(x, bp["ln1"], cfg.norm)
    q = (xin @ bp["wq"].to(cdt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (xin @ bp["wk"].to(cdt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (xin @ bp["wv"].to(cdt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    window = cfg.window
    if slot_positions is not None:
        # continuous-batching decode: each row writes its ring slot and
        # attends by absolute position, through the block table on a
        # paged pool
        update = (attn_lib.paged_ring_slot_update_attend if "bt" in cache
                  else attn_lib.ring_slot_update_attend)
        out = update(q, cache, k, v, slot_positions, window=window,
                     done=slot_done)
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        ring = ck.shape[1]  # the ring modulus (>= window once padded)
        if plens is not None and S > 1:
            # bucketed admission prefill: each row's ring from its TRUE
            # prompt length, by absolute position
            ck.copy_(attn_lib.ring_fill_rows(k, plens, ring, ck.dtype))
            cv.copy_(attn_lib.ring_fill_rows(v, plens, ring, cv.dtype))
            out = attn_lib.attention(q, k, v, causal=True, window=window,
                                     q_offset=q_offset, chunk_q=cfg.attn_chunk)
        else:
            w_eff = min(S, ring)
            idx = (q_offset + S - w_eff
                   + torch.arange(w_eff, device=x.device)) % ring
            ck[:, idx] = k[:, -w_eff:].to(ck.dtype)
            cv[:, idx] = v[:, -w_eff:].to(cv.dtype)
            if S == 1:
                kpos_abs = _ring_positions(q_offset + S, ring, x.device)
                out = _ring_window_attend(q, ck.to(cdt), cv.to(cdt),
                                          kpos_abs, q_offset, cfg)
            else:
                out = attn_lib.attention(q, k, v, causal=True, window=window,
                                         q_offset=q_offset,
                                         chunk_q=cfg.attn_chunk)
    else:
        out = attn_lib.attention(q, k, v, causal=True, window=window,
                                 q_offset=q_offset, chunk_q=cfg.attn_chunk)
    x = x + out.reshape(B, S, -1) @ bp["wo"].to(cdt)
    x = x + ffn_lib.mlp(apply_norm(x, bp["ln2"], cfg.norm), bp["mlp"],
                        cfg.act)
    return x


def _run_blocks(params, x, cfg, positions, caches=None, q_offset=0,
                plens=None, slot_positions=None, slot_done=None):
    """The block stack as a Python loop over the pattern; recurrent layer
    ``i`` reads and writes ``caches["rec"][...][i]`` and attention layer
    ``j`` ``caches["attn"][...][j]`` in place (views)."""
    n = {"rec": 0, "attn": 0}
    for typ in block_pattern(cfg):
        i = n[typ]
        n[typ] += 1
        bp = take_layer(params[f"{typ}_blocks"], i)
        cache_l = None if caches is None else {
            name: leaf[i] for name, leaf in caches[typ].items()}
        if typ == "rec":
            x = _rec_block(x, bp, cfg, cache=cache_l, plens=plens,
                           done=slot_done)
        else:
            x = _attn_block(x, bp, cfg, positions, cache_l, q_offset,
                            slot_positions=slot_positions,
                            slot_done=slot_done, plens=plens)
    return x


def _embed(params, tokens, cfg):
    cdt = getattr(torch, cfg.compute_dtype)
    x = params["embed"].to(cdt)[tokens.long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    return x


def _head(params, x, cfg):
    x = apply_norm(x, params["final_norm"], cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w.to(x.dtype)


# ----------------------------------------------------------------- forward
def forward(params, batch, cfg):
    """Full forward (no cache). batch: {"tokens": (B, S)[, "positions"]}.
    Returns (logits (B, S, V), {"moe_aux": 0.0})."""
    x = _embed(params, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = _run_blocks(params, x, cfg, positions)
    return _head(params, x, cfg), {"moe_aux": 0.0}


# -------------------------------------------------------------------- serve
def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """{"rec": {"conv": (n_rec, B, K-1, W), "h": (n_rec, B, W) f32},
    "attn": {"k", "v": (n_attn, B, ring, KV, hd)}} zeros, ring =
    ``pad_cache_len(min(max_len, window))``: the local attention's window
    cache is O(window) per slot."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    n_rec, n_attn = _counts(cfg)
    wlen = pad_cache_len(min(max_len, cfg.window or max_len))
    B, W = batch_size, cfg.lru_width
    cache = {"rec": {
        "conv": torch.zeros((n_rec, B, cfg.conv_width - 1, W), dtype=dtype,
                            device=device),
        "h": torch.zeros((n_rec, B, W), dtype=torch.float32, device=device),
    }}
    if n_attn:
        shape = (n_attn, B, wlen, cfg.n_kv_heads, cfg.head_dim)
        cache["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache


def _forward_cached(params, batch, cfg, cache, q_offset, plens=None, at=None):
    """Cached forward from ``q_offset``.  ``at`` (B,) picks one position
    per row whose logits are returned as (B, V); None returns (B, S, V)."""
    x = _embed(params, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = (q_offset + torch.arange(S, device=x.device))[None].expand(
        B, S)
    x = _run_blocks(params, x, cfg, positions, caches=cache,
                    q_offset=q_offset, plens=plens)
    if at is not None:
        x = x[torch.arange(B, device=x.device), at]
    return _head(params, x, cfg), cache


def prefill(params, batch, cfg, cache):
    """Run the prompt, filling the cache in place.  Returns (last-position
    logits (B, V), cache)."""
    B, S = batch["tokens"].shape
    last = torch.full((B,), S - 1, dtype=torch.long,
                      device=batch["tokens"].device)
    return _forward_cached(params, batch, cfg, cache, 0, at=last)


def decode_step(params, tokens, pos, cache, cfg):
    """One decode step, every row at position ``pos``: tokens (B,) int.
    Runs ``rglru_step`` and the plain ``_ring_window_attend`` (no kernel).
    Returns (logits (B, V), cache)."""
    logits, cache = _forward_cached(params, {"tokens": tokens[:, None]}, cfg,
                                    cache, pos)
    return logits[:, -1], cache


def prefill_full(params, batch, cfg, cache):
    """Admission prefill: logits at EVERY position and each row's state.

    ``batch["plens"]`` (B,) carries each row's true prompt length: RG-LRU
    pad positions freeze to identity, conv tails are gathered at the row
    boundary and ring caches are filled per row by absolute position, so
    the cache holds the state after each row's real prompt."""
    plens = batch.get("plens")
    batch = {k: v for k, v in batch.items() if k != "plens"}
    return _forward_cached(params, batch, cfg, cache, 0, plens=plens)


def prefill_last(params, tokens, plens, cfg, cache):
    """Admission prefill with logits only at each row's true last prompt
    position, (B, V): ``prefill_full``'s rows, without the (B, S, V)
    logits (8 x 4096 x 256,000 floats at recurrentgemma-2b's size)."""
    return _forward_cached(params, {"tokens": tokens}, cfg, cache, 0,
                           plens=plens, at=plens.long() - 1)


def decode_step_slots(params, tokens, positions, cache, cfg, done=None):
    """Continuous-batching decode: one token per slot at per-slot lengths.

    tokens/positions: (B,) -- each row's last token and current length.
    ``done`` rows keep their recurrent state (conv tails, RG-LRU h) and
    their ring slots bit for bit; live rows advance the recurrence and
    write their ring slot at ``pos % ring``.  Returns (logits (B, V),
    cache) with the cache updated in place."""
    x = _embed(params, tokens[:, None], cfg)
    x = _run_blocks(params, x, cfg, positions[:, None], caches=cache,
                    slot_positions=positions, slot_done=done)
    return _head(params, x, cfg)[:, -1], cache


def serve_supported(cfg):
    """Capability probe for the continuous-batching slot protocol."""
    has_attn = _counts(cfg)[1] > 0
    if has_attn and not cfg.window:
        return False, "griffin local-attention blocks require cfg.window"
    detail = "recurrent state (O(1) per slot: rglru h + conv tail)"
    if has_attn:
        detail += " + ring-buffer window KV (O(window) per slot)"
    return True, detail


def slot_cache_layout(cfg):
    return "recurrent+ring" if _counts(cfg)[1] else "recurrent"


def paged_groups(cfg):
    """Slot-state protocol: the local-attention ring K/V pages; the
    recurrent group (rglru h + conv tail, O(1) per slot) stays dense."""
    if _counts(cfg)[1]:
        return {"attn": ("seq", ("k", "v"))}
    return {}
