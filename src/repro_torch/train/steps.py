"""Step builders: train / eval / operator-grow / prefill / decode /
admission / macro-step.

PyTorch runs eagerly, so the builders return plain closures.  Training
steps take gradients with ``torch.autograd.grad`` over every leaf of the
trained tree and hand them to the optimizer; they return the reference
package's metric keys (``loss``, ``ce``, ``grad_norm``, ``lr``).  The serving
macro-step is a Python loop of K slot-decode steps that never reads a value
back to the host; with a non-greedy ``SamplingParams`` the admission
prefill and the macro-step draw from per-request threefry chains
(``serve/sampling.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models import get_family
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loss import loss_for
from repro_torch.utils.pytree import tree_leaves, tree_map


def value_and_grad(fn, params, *args):
    """``fn(params, *args) -> (loss, metrics)``; returns (grads, metrics)
    with a gradient for every leaf of ``params`` (zeros where unused)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    with torch.enable_grad():
        loss, metrics = fn(p, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)}
    return (tree_map(lambda t: by_leaf[id(t)], p),
            {k: v.detach() for k, v in metrics.items()})


def _accumulated(grad_fn, params, micro):
    """Mean grads and metrics over the microbatches in ``micro``, summed in
    f32 (one microbatch passes through as it is)."""
    if len(micro) == 1:
        return grad_fn(params, micro[0])
    g_acc = m_acc = None
    for mb in micro:
        grads, metrics = grad_fn(params, mb)
        if g_acc is None:
            g_acc = tree_map(lambda g: g.float(), grads)
            m_acc = {k: v.float() for k, v in metrics.items()}
        else:
            g_acc = tree_map(torch.add, g_acc, grads)
            m_acc = {k: m_acc[k] + v for k, v in metrics.items()}
    n = len(micro)
    return (tree_map(lambda g: g / n, g_acc),
            {k: v / n for k, v in m_acc.items()})


def make_train_step(cfg, opt_cfg: OptimizerConfig, schedule=None,
                    n_microbatches: int = 1, grad_transform=None):
    """-> step_fn(params, opt_state, batch, step) -> (params, state, metrics).

    ``n_microbatches`` > 1 splits the global batch into that many
    contiguous slices (along each input's first axis of the global batch
    size) and accumulates their grads sequentially.  ``grad_transform`` --
    optional hook applied to the averaged grads before the optimizer.
    The step updates params and state in place and returns them, as the
    reference launcher's jitted step donates their buffers.
    """
    fam = get_family(cfg)
    loss_fn = loss_for(cfg)
    _, update_fn = make_optimizer(opt_cfg, schedule)

    def fwd_loss(params, batch):
        logits, aux = fam.forward(params, batch, cfg)
        return loss_fn(logits, aux, batch, cfg)

    def grad_fn(params, batch):
        return value_and_grad(fwd_loss, params, batch)

    def split(batch):
        # one microbatch takes no split (a ``cls`` batch has no "tokens");
        # more read the global batch size from "tokens", as the reference
        # does
        n = n_microbatches
        if n == 1:
            return [batch]
        B = batch["tokens"].shape[0]

        def part(x, i):
            ax = next(a for a, s in enumerate(x.shape) if s == B)
            return x.narrow(ax, i * (B // n), B // n)
        return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]

    def step_fn(params, opt_state, batch, step):
        grads, metrics = _accumulated(grad_fn, params, split(batch))
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = update_fn(params, opt_state, grads,
                                                   step)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step_fn


def make_eval_step(cfg):
    fam = get_family(cfg)
    loss_fn = loss_for(cfg)

    @torch.no_grad()
    def eval_fn(params, batch):
        logits, aux = fam.forward(params, batch, cfg)
        _, metrics = loss_fn(logits, aux, batch, cfg)
        return metrics

    return eval_fn


def make_grow_step(gop, cfg_tgt, opt_cfg: OptimizerConfig,
                   n_microbatches: int = 1):
    """Operator-training step (paper Eq. 7): one Adam update on the whole
    operator tree (cores, layer and width maps).

    fn(op_params, opt_state, small_params, batch, step) ->
        (op_params, opt_state, metrics), op_params and opt_state updated in
        place as in the train step.

    The big model is grown inside the step and dropped after it.  With
    ``n_microbatches`` > 1 the growth contraction is recomputed per
    microbatch (split along axis 0) in exchange for an n_micro x smaller
    activation stash of the target model's forward and backward.
    """
    from repro_torch.core import grow as growlib

    fam = get_family(cfg_tgt)
    loss_fn = loss_for(cfg_tgt)
    _, update_fn = make_optimizer(opt_cfg)

    def objective(op_params, small_params, batch):
        big = growlib.grow_params(gop, op_params, small_params)
        logits, aux = fam.forward(big, batch, cfg_tgt)
        return loss_fn(logits, aux, batch, cfg_tgt)

    def grad_fn(op_params, small_params, batch):
        return value_and_grad(objective, op_params, small_params, batch)

    def step_fn(op_params, opt_state, small_params, batch, step):
        n = n_microbatches
        micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(n)]
        grads, metrics = _accumulated(
            lambda p, mb: grad_fn(p, small_params, mb), op_params, micro)
        op_params, opt_state, opt_metrics = update_fn(op_params, opt_state,
                                                      grads, step)
        metrics.update(opt_metrics)
        return op_params, opt_state, metrics

    return step_fn


def make_prefill_step(cfg):
    fam = get_family(cfg)

    def prefill_fn(params, batch, cache):
        return fam.prefill(params, batch, cfg, cache)

    return prefill_fn


def make_decode_step(cfg):
    """One greedy serving step: feed current tokens, emit next + cache."""
    fam = get_family(cfg)

    def decode_fn(params, tokens, pos, cache):
        logits, cache = fam.decode_step(params, tokens, pos, cache, cfg)
        return logits.argmax(-1).to(torch.int32), cache

    return decode_fn


def make_prefill_full_step(cfg):
    """Prefill that returns logits at every position, (B, S, V): prompts
    padded to a bucket length are read at each row's true last token."""
    fam = get_family(cfg)
    if not hasattr(fam, "prefill_full"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no full-logits prefill")

    def prefill_fn(params, batch, cache):
        return fam.prefill_full(params, batch, cfg, cache)

    return prefill_fn


def make_slot_decode_step(cfg):
    """One greedy continuous-batching step: every batch row is a cache
    slot at its own length.

    fn(params, tokens (B,), positions (B,), cache) -> (next (B,) int32,
    cache).
    """
    fam = get_family(cfg)
    if not hasattr(fam, "decode_step_slots"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no slot-indexed decode path")

    def decode_fn(params, tokens, positions, cache):
        logits, cache = fam.decode_step_slots(params, tokens, positions,
                                              cache, cfg)
        return logits.argmax(-1).to(torch.int32), cache

    return decode_fn


def make_prefill_admit_step(cfg, sampling=None):
    """Batched admission prefill for the continuous-batching engine.

    fn(params, tokens (N, Sbucket), plens (N,), cache) -> (first (N,) int32,
    cache): all requests of one prefill bucket run as ONE multi-row
    forward, and each row's first generated token (argmax at its true last
    prompt position) is computed on the device.

    With a non-greedy ``sampling`` (``serve.sampling.SamplingParams``) the
    signature gains per-row chain roots --
    fn(params, tokens, plens, cache, uids (N,), skips (N,)) ->
    (first, cache, keys (N, 2)) -- each row's chain is seeded from
    (sampling.seed, uid) on the device, advanced ``skips[i]`` splits (the
    journal-resume hook: a re-admitted sequence has already sampled that
    many tokens; fresh admissions pass zeros), its first key samples the
    first token, and the advanced chains come back for the admission
    scatter.  The reference advances under a mask for every bucket
    position; steps past the largest skip change nothing, so when
    ``skips`` lies on the CPU the loop stops there, with no host read.
    """
    from repro_torch.serve import sampling as sampling_lib

    fam = get_family(cfg)

    if sampling_lib.is_greedy(sampling):
        def prefill_fn(params, tokens, plens, cache):
            logits, cache = fam.prefill_last(params, tokens, plens, cfg,
                                             cache)
            return logits.argmax(-1).to(torch.int32), cache

        return prefill_fn

    def prefill_sampled(params, tokens, plens, cache, uids, skips):
        logits, cache = fam.prefill_last(params, tokens, plens, cfg, cache)
        roots = sampling_lib.request_key(sampling.seed, uids)
        bound = tokens.shape[1]
        if skips.device.type == "cpu":
            bound = min(bound, int(skips.max()) if skips.numel() else 0)
        if bound:
            skips = skips.to(roots.device, non_blocking=True)
        for i in range(bound):
            # a committed token consumed one split of its chain
            advanced, _ = sampling_lib.next_keys(roots)
            roots = torch.where((i < skips)[:, None], advanced, roots)
        keys, subs = sampling_lib.next_keys(roots)
        first = sampling_lib.sample_logits(logits, subs, sampling)
        return first, cache, keys

    return prefill_sampled


def make_slot_decode_loop(cfg, k: int, sampling=None):
    """Macro-step: K slot-decode steps with no host sync.

    fn(params, tokens (B,), positions (B,), remaining (B,), eos_ids (B,),
       done (B,), cache) ->
        (block (K, B) int32, valid (K, B) bool, poison (B,) bool,
         tokens, positions, remaining, done, cache)

    eos / max-new-token stopping is applied per slot inside the loop: a
    row that finishes (or starts the block idle) stops advancing -- its
    position and token freeze and ``decode_step_slots`` attends it with
    kv_len == 0.  ``valid[i, b]`` marks whether ``block[i, b]`` is a really
    generated token; rows emit their eos token as valid and then go quiet.
    ``poison`` is the NaN/Inf sentinel: a live row whose logits come back
    non-finite freezes on that step like an eos row (its token is never
    committed) and is flagged for the engine to quarantine.  ``eos_ids``
    uses -1 for "no eos"; ``remaining`` counts decode tokens still owed.

    With a non-greedy ``sampling`` the signature gains per-slot PRNG
    chains -- fn(..., cache, keys (B, 2)) -> (..., cache, keys) -- and each
    step draws from the temperature/top-k/top-p-filtered distribution.  A
    chain advances only where its row really samples, so a request's
    tokens are a pure function of (seed, uid, prompt).
    """
    from repro_torch.serve import sampling as sampling_lib

    fam = get_family(cfg)
    greedy = sampling_lib.is_greedy(sampling)

    def loop_fn(params, tokens, positions, remaining, eos_ids, done, cache,
                keys=None):
        poison = torch.zeros_like(done)
        block, valid = [], []
        for _ in range(k):
            live = ~done
            logits, cache = fam.decode_step_slots(params, tokens, positions,
                                                  cache, cfg, done=done)
            bad = live & ~torch.isfinite(logits.float()).all(-1)
            live = live & ~bad
            poison = poison | bad
            if greedy:
                nxt = logits.argmax(-1).to(torch.int32)
            else:
                advanced, subs = sampling_lib.next_keys(keys)
                keys = torch.where(live[:, None], advanced, keys)
                nxt = sampling_lib.sample_logits(logits, subs, sampling)
            tokens = torch.where(live, nxt, tokens)
            remaining = torch.where(live, remaining - 1, remaining)
            done = done | bad | (live & ((tokens == eos_ids)
                                         | (remaining <= 0)))
            positions = torch.where(live, positions + 1, positions)
            block.append(tokens)
            valid.append(live)
        out = (torch.stack(block), torch.stack(valid), poison, tokens,
               positions, remaining, done, cache)
        return out if greedy else (*out, keys)

    return loop_fn
