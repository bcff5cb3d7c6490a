"""xLSTM family (arXiv:2405.04517), ported: mLSTM (matrix memory) and
sLSTM blocks.

A multi-token pass (forward, prefill) runs the mLSTM in chunkwise-recurrent
form: within a chunk the contribution is a decay-masked, attention-like
quadratic form; across chunks a (dh x dh) matrix state C, a normaliser n
and a stabiliser m are carried, so the work is O(S * chunk) and the state
O(1) in S.  A single-token step runs the recurrence itself
(``mlstm_sequential``), which is also the chunkwise form's oracle.  The
sLSTM block is a true recurrence through block-diagonal recurrent gates,
a Python loop over positions, as the reference's ``lax.scan``.

The reference computes both cells in plain ``jnp`` outside any Pallas
kernel, so they stay plain PyTorch here (``torch.matmul`` / ``einsum``);
the family reaches no kernel of the port when it serves.  Growing into an
xlstm goes through the Mango contraction's sandwich kernel like every
family.

Caches are updated in place (the reference returns new buffers, which XLA
aliases through donation): layer ``i`` of group ``"m"`` or ``"s"`` reads
and writes views of the pool.  On a paged pool (``serve/paged.py``) each
group's conv tail pages as a ``"slot"`` group -- one page a slot holding
the whole K-1 tail, ``"bt"`` its one-entry block table -- while the
mLSTM C/n/m and the sLSTM carries stay dense per slot inside the same
group dict.  A recurrence cannot re-store an update, so the speculative
hooks keep a copy of every slot's state: ``verify_step_slots`` stacks the
state after each chunk position and ``commit_slots`` gathers each row's
accepted one; a draft proposes in place, so ``snapshot_slots`` /
``restore_slots`` put its whole state back before its catch-up.

Eager, both cells are bound by host time per op at xlstm-1.3b's size (a
slot-decode step is ~2,500 small device ops, the sLSTM ~20 a position),
so on the card a single-token step, and each sLSTM time step of a pass
without grad, replays a CUDA graph of the same kernels (``CUDA_GRAPHS``);
the CPU runs eagerly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.weak

from repro_torch.models.common import (
    apply_norm,
    gelu,
    init_norm,
    meta_shapes,
    spec_commit_gather,
    spec_verify_scan,
    take_layer,
    trunc_normal,
)
from repro_torch.models.griffin import _causal_conv
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map

M_INIT = -1e30  # the stabiliser's start: exp(m0 + ...) underflows to 0
# On the card a single-token step, and an sLSTM time step without grad,
# replay a CUDA graph; False runs them eagerly (the reference the card
# tests hold the graphs against)
CUDA_GRAPHS = True


def _as(t, dtype):
    """``t`` in ``dtype``, with no call at all when it already is (an eager
    pass is bound by host time per op at xlstm-1.3b's size)."""
    return t if t.dtype == dtype else t.to(dtype)


def block_types(cfg):
    """Per-layer type list: 'm' (mLSTM) or 's' (sLSTM)."""
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    return tuple("s" if cfg.slstm_every
                 and i % cfg.slstm_every == cfg.slstm_every - 1 else "m"
                 for i in range(cfg.n_layers))


def _counts(cfg):
    types = block_types(cfg)
    n_m = sum(1 for t in types if t == "m")
    return n_m, len(types) - n_m


def _inner(cfg):
    """(mLSTM inner width di, mLSTM head dim, sLSTM head dim)."""
    di = int(cfg.proj_factor * cfg.d_model)
    return di, di // cfg.n_heads, cfg.d_model // cfg.n_heads


# -------------------------------------------------------------------- init
def init(gen: torch.Generator, cfg, device=None) -> dict:
    """Random params drawn from ``gen``, on ``device`` (default: the
    generator's device), in the reference's tree and layouts."""
    device = device or gen.device
    dtype = getattr(torch, cfg.param_dtype)
    std = 0.02
    D, NH = cfg.d_model, cfg.n_heads
    di, _, dh = _inner(cfg)
    n_m, n_s = _counts(cfg)
    K = cfg.conv_width

    def w(*shape):
        return trunc_normal(gen, shape, std, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params = {"embed": w(cfg.vocab_size, D)}
    params["m_blocks"] = {
        "ln": init_norm(cfg.norm, D, n_m, dtype, device),
        "w_up": w(n_m, D, 2 * di), "conv_w": w(n_m, K, di),
        "conv_b": zeros(n_m, di),
        "w_q": w(n_m, di, di), "w_k": w(n_m, di, di), "w_v": w(n_m, di, di),
        "w_if": w(n_m, di, 2 * NH), "b_if": zeros(n_m, 2 * NH),
        # per-head group norm scale
        "gn": torch.ones((n_m, di), dtype=dtype, device=device),
        "w_down": w(n_m, di, D),
    }
    if n_s:
        dff = int(4.0 / 3.0 * D)
        params["s_blocks"] = {
            "ln": init_norm(cfg.norm, D, n_s, dtype, device),
            "conv_w": w(n_s, K, D), "conv_b": zeros(n_s, D),
            "w_gates": w(n_s, D, 4 * D), "r_gates": w(n_s, NH, dh, 4 * dh),
            "b_gates": zeros(n_s, 4 * D),
            "gn": torch.ones((n_s, D), dtype=dtype, device=device),
            "w_up1": w(n_s, D, dff), "w_up2": w(n_s, D, dff),
            "w_down": w(n_s, dff, D),
        }
    params["final_norm"] = init_norm(cfg.norm, D, None, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = w(D, cfg.vocab_size)
    return params


def param_shapes(cfg) -> dict:
    """``init``'s shapes (``common.meta_shapes``)."""
    return meta_shapes(init, cfg)


# --------------------------------------------------------- paged conv tails
def _conv_tail_gather(arena, bt):
    """Dense per-slot view of one layer's paged conv tail.

    arena: (n_pages + 1, K-1, d); bt: (B, 1), a one-entry table (the whole
    tail is one page).  A sentinel entry reads the scratch page ``n_pages``
    (the reference clamps it to page ``n_pages - 1``): either way the tail
    belongs to a row whose state writes are dropped and whose logits the
    engine masks."""
    return arena[bt[:, 0].long()]


def _conv_tail_scatter(arena, bt, tail, done=None):
    """Write each live row's new conv tail to its page, in place; ``done``
    rows (and sentinel entries) write the scratch page ``n_pages``, which
    the reference's out-of-range drop stands for."""
    pid = bt[:, 0].long()
    if done is not None:
        pid = torch.where(done, arena.shape[0] - 1, pid)
    arena[pid] = tail.to(arena.dtype)
    return arena


# -------------------------------------------------------------- mLSTM cell
def _group_norm(x, scale, nh, eps=1e-6):
    """Per-head RMS-style group norm. x: (..., di)."""
    shp = x.shape
    xh = _as(x, torch.float32).reshape(*shp[:-1], nh, shp[-1] // nh)
    xh = F.rms_norm(xh, (shp[-1] // nh,), eps=eps)
    return _as(xh.reshape(shp) * _as(scale, torch.float32), x.dtype)


def _zero_state(B, NH, dh, device):
    return (torch.zeros((B, NH, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, NH, dh), dtype=torch.float32, device=device),
            torch.full((B, NH), M_INIT, dtype=torch.float32, device=device))


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk=256):
    """Chunkwise mLSTM.

    q, k, v: (B, NH, S, dh), q pre-scaled by dh**-0.5; log_i, log_f: (B,
    NH, S) f32 gate log-activations; state: None or (C (B, NH, dh, dh), n
    (B, NH, dh), m (B, NH)) f32.  Returns (h (B, NH, S, dh) in q's dtype,
    the final state).  ``S % chunk`` falls back to one chunk.
    """
    B, NH, S, dh = q.shape
    if S % chunk:
        chunk = S
    C, n, m = state if state is not None else _zero_state(B, NH, dh,
                                                          q.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    hs = []
    for j in range(S // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        qf, kf, vf = (a[:, :, sl].float() for a in (q, k, v))
        li, lf = log_i[..., sl], log_f[..., sl]
        b = torch.cumsum(lf, -1)  # inclusive forget cumsum (B, NH, T)
        btot = b[..., -1]
        # per-step stabiliser: m_t = max(m_prev + b_t, b_t + max_{s<=t}
        # (li_s - b_s)), the reference's associative_scan(maximum)
        run_max = torch.cummax(li - b, -1).values
        m_t = torch.maximum(m[..., None] + b, b + run_max)
        m_intra = (li - b).amax(-1)
        # inter-chunk part
        scale_inter = torch.exp(m[..., None] + b - m_t)
        h_inter = torch.einsum("bhtd,bhde->bhte", qf, C) \
            * scale_inter[..., None]
        d_inter = torch.einsum("bhtd,bhd->bht", qf, n) * scale_inter
        # intra-chunk decay matrix D[t, s] = exp(b_t - b_s + li_s - m_t),
        # masked to -inf above the diagonal before the exp
        dmat = b[..., :, None] - b[..., None, :] + li[..., None, :] \
            - m_t[..., :, None]
        dexp = torch.exp(torch.where(tri, dmat, float("-inf")))
        scores = torch.einsum("bhtd,bhsd->bhts", qf, kf) * dexp
        h_intra = torch.einsum("bhts,bhse->bhte", scores, vf)
        d_intra = scores.sum(-1)
        denom = torch.maximum((d_inter + d_intra).abs(), torch.exp(-m_t))
        hs.append(((h_inter + h_intra) / denom[..., None]).to(q.dtype))
        # state update to the end of the chunk
        m_next = torch.maximum(m + btot, btot + m_intra)
        sc_old = torch.exp(m + btot - m_next)  # (B, NH)
        sc_new = torch.exp(btot[..., None] - b + li - m_next[..., None])
        C = C * sc_old[..., None, None] \
            + torch.einsum("bht,bhtd,bhte->bhde", sc_new, kf, vf)
        n = n * sc_old[..., None] + torch.einsum("bht,bhtd->bhd", sc_new, kf)
        m = m_next
    return torch.cat(hs, 2), (C, n, m)


def _mlstm_step(C, n, m, qt, kt, vt, li, lf):
    """One step of the recurrence: qt, kt, vt (B, NH, dh) f32, li, lf (B,
    NH).  -> (h (B, NH, dh), C, n, m).  ``C_t = f C + i k v^T`` with ``i
    k`` formed first (one product of the matrix size fewer)."""
    a = lf + m
    m_new = torch.maximum(a, li)
    i_p = torch.exp(li - m_new)[..., None]
    f_p = torch.exp(a - m_new)[..., None]
    ik = i_p * kt
    C = torch.addcmul(f_p[..., None] * C, ik[..., :, None], vt[..., None, :])
    n = torch.addcmul(ik, f_p, n)
    num = (qt[..., None, :] @ C)[..., 0, :]
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


def mlstm_sequential(q, k, v, log_i, log_f, state=None):
    """Step-by-step recurrence: the chunkwise form's oracle and the decode
    path (S == 1).  Same arguments and returns as ``mlstm_chunkwise``."""
    B, NH, S, dh = q.shape
    C, n, m = state if state is not None else _zero_state(B, NH, dh,
                                                          q.device)
    dt = q.dtype
    q, k, v = (_as(a, torch.float32) for a in (q, k, v))
    hs = []
    for t in range(S):
        h, C, n, m = _mlstm_step(C, n, m, q[:, :, t], k[:, :, t],
                                 v[:, :, t], log_i[..., t], log_f[..., t])
        hs.append(h)
    return _as(torch.stack(hs, 2), dt), (C, n, m)


def _conv_state(cache):
    if cache is None:
        return None
    if "bt" in cache:
        return _conv_tail_gather(cache["conv"], cache["bt"])
    return cache["conv"]


def _write_state(cache, new_conv, state, done):
    """This layer's new state into its pool views, in place: the carries
    (``done`` rows keep theirs bit for bit: one ``where`` into the pool)
    and the conv tail, through the block table on a paged pool."""
    if "bt" in cache:
        _conv_tail_scatter(cache["conv"], cache["bt"], new_conv, done)
    else:
        state = dict(state, conv=new_conv)
    for name, t in state.items():
        leaf = cache[name]
        if done is None:
            leaf.copy_(t)
        else:
            keep = done.reshape(done.shape + (1,) * (leaf.dim() - 1))
            torch.where(keep, leaf, _as(t, leaf.dtype), out=leaf)


def _mlstm_block(x, bp, cfg, cache=None, chunkwise=True, plens=None,
                 done=None):
    """x: (B, S, D).  cache: this layer's {"conv", "C", "n", "m"} views of
    the pool (plus "bt" on a paged pool), written in place, or None.

    ``plens`` (B,): bucketed admission prefill -- pad positions freeze the
    recurrence exactly (input gate exp(-inf) = 0, forget log 0) and the
    conv tail is gathered at each row's true boundary, so the carried
    (C, n, m) is the state after the REAL prompt.  ``done`` (B,):
    slot-decode rows whose state must not advance.
    """
    B, S, D = x.shape
    NH = cfg.n_heads
    di, dh, _ = _inner(cfg)
    dt = x.dtype
    xin = apply_norm(x, bp["ln"], cfg.norm)
    up = xin @ _as(bp["w_up"], dt)
    xi, z = up[..., :di], up[..., di:]
    c, new_conv = _causal_conv(xi, bp["conv_w"], bp["conv_b"],
                               _conv_state(cache), lengths=plens)
    c = F.silu(c)

    def heads(a):
        return a.reshape(B, S, NH, dh).transpose(1, 2)

    q = heads(c @ _as(bp["w_q"], dt)) * (dh ** -0.5)
    k = heads(c @ _as(bp["w_k"], dt))
    v = heads(xi @ _as(bp["w_v"], dt))
    f32 = torch.float32
    gates = F.linear(_as(c, f32), _as(bp["w_if"], f32).T,
                     _as(bp["b_if"], f32))
    gates = gates.reshape(B, S, 2, NH).permute(2, 0, 3, 1)  # (2, B, NH, S)
    log_i, log_f = gates[0], F.logsigmoid(gates[1])
    if plens is not None:
        valid = (torch.arange(S, device=x.device)[None]
                 < plens[:, None])[:, None, :]  # (B, 1, S)
        log_i = torch.where(valid, log_i, float("-inf"))
        log_f = torch.where(valid, log_f, 0.0)

    state = None if cache is None else (cache["C"], cache["n"], cache["m"])
    if S == 1 or not chunkwise:
        h, state = mlstm_sequential(q, k, v, log_i, log_f, state)
    else:
        h, state = mlstm_chunkwise(q, k, v, log_i, log_f, state,
                                   chunk=min(cfg.attn_chunk, 256))
    h = _group_norm(h.transpose(1, 2).reshape(B, S, di), bp["gn"], NH)
    h = h * F.silu(z)
    x = x + h @ _as(bp["w_down"], dt)
    if cache is not None:
        _write_state(cache, new_conv, dict(zip(("C", "n", "m"), state)),
                     done)
    return x


# -------------------------------------------------------------- sLSTM cell
def _capture(fn):
    """(graph, ``fn()``'s output as captured): ``fn`` runs once on a side
    stream first (the warm-up the capture needs; it must leave every state
    it touches as it was), then is captured as a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _slstm_step(pre_t, valid_t, cs, ns, hs, ms, r):
    """One sLSTM time step: pre_t (B, 4, NH, dh) gate pre-activations from
    the inputs, valid_t (B,) bool or None, the carries (B, NH, dh) f32, r
    (NH, dh, 4 dh).  -> (h, cs, ns, hs, ms): the step's output and the new
    carries (frozen where ``valid_t`` is false)."""
    NH, B, dh = r.shape[0], hs.shape[0], hs.shape[2]
    # the block-diagonal recurrence, a head a batch: (NH, B, 4 * dh)
    rec = torch.bmm(hs.transpose(0, 1), r).reshape(NH, B, 4, dh)
    g = pre_t + rec.permute(1, 2, 0, 3)  # (B, 4, NH, dh)
    li = g[:, 0]
    lf = F.logsigmoid(g[:, 1])
    z = torch.tanh(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    a = lf + ms
    m_new = torch.maximum(a, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(a - m_new)
    cs_n = torch.addcmul(f_p * cs, i_p, z)
    ns_n = torch.addcmul(i_p, f_p, ns)
    h = o * cs_n / torch.clamp(ns_n, min=1e-6)
    if valid_t is None:
        return h, cs_n, ns_n, h, m_new
    keep = valid_t[:, None, None]  # freeze the carry across padded positions
    return (h, torch.where(keep, cs_n, cs), torch.where(keep, ns_n, ns),
            torch.where(keep, h, hs), torch.where(keep, m_new, ms))


class _GraphedSlstmStep:
    """``_slstm_step`` captured as a CUDA graph over static inputs and
    carries (the new carries are copied into the old ones inside the
    graph), so a multi-token pass without grad pays the host one replay a
    position instead of ~20 ops (the prefill's sLSTM loop is host-bound:
    a 512-token prefill at xlstm-1.3b is 58,299 device ops, the device
    idle 0.85 of it).  The kernels are the eager step's."""

    def __init__(self, r, B, masked):
        NH, dh = r.shape[0], r.shape[1]
        f32 = dict(dtype=torch.float32, device=r.device)
        self.pre = torch.zeros((B, 4, NH, dh), **f32)
        self.valid = torch.ones((B,), dtype=torch.bool, device=r.device) \
            if masked else None
        self.carry = [torch.zeros((B, NH, dh), **f32) for _ in range(4)]

        def step():
            h, *new = _slstm_step(self.pre, self.valid, *self.carry, r)
            for c, n in zip(self.carry, new):
                c.copy_(n)
            return h
        self.graph, self.h = _capture(step)

    def run(self, pre, valid, carry):
        """All of ``pre``'s (B, S, 4, NH, dh) positions from ``carry``:
        -> (h (B, S, NH, dh), the final carries)."""
        for c, v in zip(self.carry, carry):
            c.copy_(v)
        out = []
        for t in range(pre.shape[1]):
            self.pre.copy_(pre[:, t])
            if valid is not None:
                self.valid.copy_(valid[:, t])
            self.graph.replay()
            out.append(self.h.clone())
        return torch.stack(out, 1), [c.clone() for c in self.carry]


# the stacked r_gates leaf -> {(layer offset, rows, masked): graph}: a
# graph reads its layer's r by address, and goes with the leaf
_SLSTM_GRAPHS = torch.utils.weak.WeakTensorKeyDictionary()


def _slstm_graph(r, B, masked):
    graphs = _SLSTM_GRAPHS.setdefault(r if r._base is None else r._base, {})
    key = (r.storage_offset(), B, masked)
    if key not in graphs:
        graphs[key] = _GraphedSlstmStep(r, B, masked)
    return graphs[key]


def _slstm_block(x, bp, cfg, cache=None, plens=None, done=None):
    """Sequential sLSTM block. x: (B, S, D).

    ``plens``: pad positions of a bucketed admission prefill freeze the
    carried (c, n, h, m) in the loop -- the hidden-state recurrence would
    otherwise absorb the padding.  ``done``: slot rows frozen wholesale.
    """
    B, S, D = x.shape
    NH = cfg.n_heads
    _, _, dh = _inner(cfg)
    xin = apply_norm(x, bp["ln"], cfg.norm)
    c_in, new_conv = _causal_conv(xin, bp["conv_w"], bp["conv_b"],
                                  _conv_state(cache), lengths=plens)
    c_in = F.silu(c_in)
    # gate pre-activations from the inputs: i, f from the conv branch, z, o
    # direct (xLSTM Fig. 11)
    f32 = torch.float32
    wg = _as(bp["w_gates"], f32)
    pre = torch.cat([_as(c_in, f32) @ wg[:, :2 * D],
                     _as(xin, f32) @ wg[:, 2 * D:]], -1) \
        + _as(bp["b_gates"], f32)
    pre = pre.reshape(B, S, 4, NH, dh)
    r = _as(bp["r_gates"], f32)  # (NH, dh, 4 * dh)
    if cache is None:
        zeros = torch.zeros((B, NH, dh), dtype=torch.float32,
                            device=x.device)
        cs, ns, hs = zeros, zeros, zeros
        ms = torch.full((B, NH, dh), M_INIT, dtype=torch.float32,
                        device=x.device)
    else:
        cs, ns, hs, ms = cache["c"], cache["n"], cache["h"], cache["m"]
    valid = None if plens is None else (
        torch.arange(S, device=x.device)[None] < plens[:, None])  # (B, S)
    if (S > 1 and CUDA_GRAPHS and r.is_cuda and r is bp["r_gates"]
            and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing()):
        h, (cs, ns, hs, ms) = _slstm_graph(r, B, valid is not None).run(
            pre, valid, (cs, ns, hs, ms))
    else:
        out = []
        for t in range(S):
            h, cs, ns, hs, ms = _slstm_step(
                pre[:, t], None if valid is None else valid[:, t], cs, ns,
                hs, ms, r)
            out.append(h)
        h = torch.stack(out, 1)
    dt = x.dtype
    h = _as(h.reshape(B, S, D), dt)
    h = _group_norm(h, bp["gn"], NH)
    # gated up/down MLP (pf = 4/3)
    u1 = h @ _as(bp["w_up1"], dt)
    u2 = h @ _as(bp["w_up2"], dt)
    x = x + (gelu(u1) * u2) @ _as(bp["w_down"], dt)
    if cache is not None:
        _write_state(cache, new_conv, {"c": cs, "n": ns, "h": hs, "m": ms},
                     done)
    return x


# ----------------------------------------------------------------- forward
def _run_blocks(params, x, cfg, caches=None, plens=None, done=None,
                chunkwise=True):
    """The block stack as a Python loop over ``block_types``: the i-th
    mLSTM layer reads and writes ``caches["m"][...][i]`` and the j-th sLSTM
    layer ``caches["s"][...][j]`` in place (views)."""
    # bucketed admission prefill: pad positions of the residual stream are
    # zeroed after every block -- the mLSTM stabiliser degenerates on
    # all-masked pad queries (inf denominators), and a NaN at a pad
    # position must never reach the next block's K/V products (where 0 *
    # NaN would poison the carried state)
    valid = None if plens is None else (
        torch.arange(x.shape[1], device=x.device)[None]
        < plens[:, None])[..., None]
    n = {"m": 0, "s": 0}
    for typ in block_types(cfg):
        i = n[typ]
        n[typ] += 1
        bp = take_layer(params[f"{typ}_blocks"], i)
        cache_l = None if caches is None else {
            name: leaf[i] for name, leaf in caches[typ].items()}
        if typ == "m":
            x = _mlstm_block(x, bp, cfg, cache=cache_l, chunkwise=chunkwise,
                             plens=plens, done=done)
        else:
            x = _slstm_block(x, bp, cfg, cache=cache_l, plens=plens,
                             done=done)
        if valid is not None:
            x = torch.where(valid, x, 0.0)
    return x


def _embed(params, tokens, cfg):
    return _as(params["embed"], getattr(torch, cfg.compute_dtype))[
        tokens.long()]


def _head(params, x, cfg):
    x = apply_norm(x, params["final_norm"], cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ _as(w, x.dtype)


def forward(params, batch, cfg):
    """Full forward (no cache). batch: {"tokens": (B, S)}.  Returns
    (logits (B, S, V), {"moe_aux": 0.0}): xlstm's blocks route nothing,
    whatever ``cfg.moe`` says (as in the reference)."""
    x = _run_blocks(params, _embed(params, batch["tokens"], cfg), cfg)
    return _head(params, x, cfg), {"moe_aux": 0.0}


# ------------------------------------------------------------------- serve
def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """{"m": {"conv": (n_m, B, K-1, di), "C": (n_m, B, NH, dh, dh), "n":
    (n_m, B, NH, dh), "m": (n_m, B, NH)}, "s": {"conv": (n_s, B, K-1, D),
    "c", "n", "h", "m": (n_s, B, NH, D / NH)}}: conv tails in ``dtype``
    (the compute dtype), carries in f32, stabilisers at -1e30.  O(1) per
    slot: ``max_len`` is unused."""
    del max_len
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    n_m, n_s = _counts(cfg)
    D, NH, K, B = cfg.d_model, cfg.n_heads, cfg.conv_width, batch_size
    di, dh, dhs = _inner(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    cache = {"m": {
        "conv": torch.zeros((n_m, B, K - 1, di), dtype=dtype, device=device),
        "C": torch.zeros((n_m, B, NH, dh, dh), **f32),
        "n": torch.zeros((n_m, B, NH, dh), **f32),
        "m": torch.full((n_m, B, NH), M_INIT, **f32),
    }}
    if n_s:
        cache["s"] = {
            "conv": torch.zeros((n_s, B, K - 1, D), dtype=dtype,
                                device=device),
            "c": torch.zeros((n_s, B, NH, dhs), **f32),
            "n": torch.zeros((n_s, B, NH, dhs), **f32),
            "h": torch.zeros((n_s, B, NH, dhs), **f32),
            "m": torch.full((n_s, B, NH, dhs), M_INIT, **f32),
        }
    return cache


def _forward_cached(params, tokens, cfg, cache, plens=None, done=None,
                    at=None, chunkwise=True):
    """Cached forward (the recurrence is position-free).  ``at`` (B,)
    picks one position per row whose logits come back as (B, V); None
    returns (B, S, V)."""
    x = _run_blocks(params, _embed(params, tokens, cfg), cfg, caches=cache,
                    plens=plens, done=done, chunkwise=chunkwise)
    if at is not None:
        x = x[torch.arange(x.shape[0], device=x.device), at]
    return _head(params, x, cfg), cache


def prefill(params, batch, cfg, cache, chunkwise=True):
    """Run the prompt, filling the cache in place.  Returns (last-position
    logits (B, V), cache).  ``chunkwise=False`` steps the mLSTM through
    its sequential recurrence, the chunkwise form's oracle."""
    tokens = batch["tokens"]
    last = torch.full((tokens.shape[0],), tokens.shape[1] - 1,
                      dtype=torch.long, device=tokens.device)
    return _forward_cached(params, tokens, cfg, cache, at=last,
                           chunkwise=chunkwise)


def prefill_cache(params, tokens, cfg, cache, plens=None):
    """Admission prefill that only fills the cache (no final norm, no
    head): a speculative draft's admission.  ``plens`` (B,) are the true
    prompt lengths of a bucket-padded batch, as in ``prefill_full``.
    Returns the cache, updated in place."""
    _run_blocks(params, _embed(params, tokens, cfg), cfg, caches=cache,
                plens=plens)
    return cache


# --------------------------------------------- single-token steps, graphed
# pool tensor -> {step signature: _GraphedStep}: a pool's graphs go with it
_GRAPHS = torch.utils.weak.WeakTensorKeyDictionary()


class _GraphedStep:
    """One single-token step (the blocks, and the head when ``head``)
    captured as a CUDA graph over fixed buffers: the pool, the params, and
    static tokens, ``done`` and output tensors.  A replay launches the
    step's ~2,500 kernels at once, where eager PyTorch pays the host ~20
    us for each (the step is host-bound at xlstm-1.3b's size: 3,073
    device ops a step, the device idle 0.59 of it).  The kernels are the
    eager step's, so the replay's results are its own bit for bit."""

    def __init__(self, params, tokens, cache, cfg, head):
        self.tokens = tokens.clone()
        # the capture's warm-up runs the step once for real: with every row
        # done it leaves the pool's bytes as they are (a done row's state
        # is kept bit for bit, its paged writes go to the scratch page)
        self.done = torch.ones(tokens.shape, dtype=torch.bool,
                               device=tokens.device)
        self.graph, self.out = _capture(
            lambda: self._step(params, cache, cfg, head))

    def _step(self, params, cache, cfg, head):
        if not head:
            _run_blocks(params, _embed(params, self.tokens[:, None], cfg),
                        cfg, caches=cache, done=self.done)
            return None
        return _forward_cached(params, self.tokens[:, None], cfg, cache,
                               done=self.done)[0][:, -1]

    def __call__(self, tokens, done):
        self.tokens.copy_(tokens)
        if done is None:
            self.done.fill_(False)
        else:
            self.done.copy_(done)
        self.graph.replay()
        return None if self.out is None else self.out.clone()


def _ptrs(tree):
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for _, t in tree_flatten_with_paths(tree))


def _single_step(params, tokens, cache, cfg, done, head):
    """One token a row through the blocks (and the head): eagerly on the
    CPU, as a replayed CUDA graph on the card (``_GraphedStep``; captured
    at a pool's first step of this signature).  Returns the logits (B, V)
    or None."""
    if not (CUDA_GRAPHS and tokens.is_cuda):
        if not head:
            _run_blocks(params, _embed(params, tokens[:, None], cfg), cfg,
                        caches=cache, done=done)
            return None
        return _forward_cached(params, tokens[:, None], cfg, cache,
                               done=done)[0][:, -1]
    # a graph reads and writes memory by address: it serves only the very
    # params and pool leaves it was captured on
    key = (head, tokens.dtype, tuple(tokens.shape), cfg, _ptrs(params),
           _ptrs(cache))
    graphs = _GRAPHS.setdefault(next(iter(cache["m"].values())), {})
    step = graphs.get(key)
    if step is None:
        with torch.no_grad():
            step = graphs[key] = _GraphedStep(params, tokens, cache, cfg,
                                              head)
    with torch.no_grad():
        return step(tokens, done)


def decode_step(params, tokens, pos, cache, cfg):
    """One decode step: tokens (B,) int; ``pos`` is unused (the recurrence
    is position-free).  Returns (logits (B, V), cache)."""
    del pos
    return _single_step(params, tokens, cache, cfg, None, True), cache


def prefill_full(params, batch, cfg, cache):
    """Admission prefill: logits at EVERY position and each row's state.

    ``batch["plens"]`` (B,) carries each row's true prompt length: pad
    positions add exp(-inf) = 0 to the mLSTM state with unit forget decay,
    sLSTM carries freeze in the loop and conv tails are gathered at the
    row boundary, so the cache holds the state after each row's REAL
    prompt."""
    return _forward_cached(params, batch["tokens"], cfg, cache,
                           plens=batch.get("plens"))


def prefill_last(params, tokens, plens, cfg, cache):
    """Admission prefill with logits only at each row's true last prompt
    position, (B, V): ``prefill_full``'s rows without the (B, S, V)
    logits."""
    return _forward_cached(params, tokens, cfg, cache, plens=plens,
                           at=plens.long() - 1)


def decode_step_slots(params, tokens, positions, cache, cfg, done=None):
    """Continuous-batching decode: one token per slot, O(1) state per row.

    ``positions`` is taken for the protocol's sake and unused.  Rows
    flagged ``done`` keep their whole per-slot state (C/n/m, sLSTM
    carries, conv tails) bit for bit: a recurrent update is irreversible,
    so the macro-step loop's no-op steps must not advance it.  Returns
    (logits (B, V), cache) with the cache updated in place."""
    del positions
    return _single_step(params, tokens, cache, cfg, done, True), cache


def _slot_state_step(params, tokens, positions, cache, cfg, done=None):
    """``decode_step_slots`` without the head: (None, cache).  A draft's
    catch-up verify needs only the state."""
    del positions
    return _single_step(params, tokens, cache, cfg, done, False), cache


# ------------------------------------------------------------ speculation
def _dense_state_view(cache):
    """Per-slot dense view of a (possibly paged) slot cache: paged conv
    arenas gather back to (L, B, K-1, d) through their one-entry tables
    (layers share one table); every other leaf passes through.  The
    speculative hooks keep and gather THIS view: per-slot snapshots, never
    per-page arenas."""
    out = {}
    for gk, gv in cache.items():
        dense = {k: v for k, v in gv.items() if k != "bt"}
        if "bt" in gv:
            dense["conv"] = gv["conv"][:, gv["bt"][0][:, 0].long()]
        out[gk] = dense
    return out


def _write_dense_view(cache, dense):
    """Put a ``_dense_state_view``-shaped tree back into the pool, in
    place: paged conv tails through the table (sentinel rows write the
    scratch page), every other leaf wholesale.  Returns the cache."""
    for gk, gv in cache.items():
        for name, t in dense[gk].items():
            if name == "conv" and "bt" in gv:
                gv["conv"][:, gv["bt"][0][:, 0].long()] = t
            else:
                gv[name].copy_(t)
    return cache


def snapshot_slots(cache, positions, n):
    """Every slot's whole recurrent state, copied (the dense view): a run
    of ``n`` slot-decode steps overwrites all of it.  The speculative draft
    takes one before it proposes in place, and ``restore_slots`` puts it
    back, so its catch-up verify starts from the committed state; the
    verify takes one for its commit."""
    del positions, n
    return {"old": tree_map(lambda t: t.clone(), _dense_state_view(cache))}


def restore_slots(cache, snap, positions, n):
    """Undo a run of slot-decode steps in place: the whole state back to
    ``snap`` (``snapshot_slots``).  Returns the cache."""
    del positions, n
    return _write_dense_view(cache, snap["old"])


def verify_step_slots(params, tokens, positions, cache, cfg, done=None,
                      logits=True):
    """Speculative verify for the recurrent slot layout: the single-token
    slot decode run over the chunk (``spec_verify_scan``), in place,
    stacking the slot state after each chunk position (every xlstm leaf is
    O(1) a slot).  Paged pools stack the per-slot dense view (conv tails
    gathered through the table).  Equal to sequential decode by
    construction.  ``logits=False`` skips the head (a draft's catch-up)
    and returns (None, pending)."""
    pending = snapshot_slots(cache, positions, tokens.shape[1])
    out, stacked, _ = spec_verify_scan(
        decode_step_slots if logits else _slot_state_step, params, tokens,
        positions, cache, cfg, done=done, stack_filter=_dense_state_view)
    pending["stacked"] = stacked
    return out, pending


def commit_slots(params, tokens, positions, n_feed, cache, pending, cfg,
                 done=None):
    """Commit = gather the stacked verify states at ``n_feed - 1`` per row
    and write them into the pool in place; rows with ``n_feed == 0`` or
    flagged ``done`` get their pre-chunk state back (a recurrent update
    cannot be re-stored, so rollback is a snapshot gather, not a
    truncation).  Paged pools gather in the dense per-slot view and
    scatter the committed conv tails back to their pages."""
    del params, tokens, positions, cfg
    committed = spec_commit_gather(pending["old"], pending["stacked"],
                                   n_feed, done=done)
    return _write_dense_view(cache, committed)


def serve_supported(cfg):
    """Capability probe for the continuous-batching slot protocol."""
    return True, ("recurrent state (O(1) per slot: mLSTM C/n/m + conv "
                  "tails, sLSTM c/n/h/m)")


def slot_cache_layout(cfg):
    return "recurrent"


def paged_groups(cfg):
    """Slot-state protocol: the conv shift tails page (one single-entry
    block per slot -- the tail has no sequence axis, so the whole K-1
    window is its page); the mLSTM C/n/m and sLSTM carries stay dense per
    slot (O(1) matrix and vector state, nothing to page)."""
    n_m, n_s = _counts(cfg)
    out = {}
    if n_m:
        out["m"] = ("slot", ("conv",))
    if n_s:
        out["s"] = ("slot", ("conv",))
    return out
