"""Step builders for serving: prefill / decode / admission / macro-step.

Only greedy serving is ported; training, growth and sampled decode come in
later slices (ROADMAP.md).  PyTorch runs eagerly, so the builders return
plain closures; the macro-step is a Python loop of K slot-decode steps
that never reads a value back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.models import get_family


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


def make_prefill_admit_step(cfg):
    """Batched greedy admission prefill for the continuous-batching engine.

    fn(params, tokens (N, Sbucket), plens (N,), cache) -> (first (N,) int32,
    cache): all requests of one prefill bucket run as ONE multi-row
    forward, and each row's first generated token (argmax at its true last
    prompt position) is computed on the device.
    """
    fam = get_family(cfg)

    def prefill_fn(params, tokens, plens, cache):
        logits, cache = fam.prefill_last(params, tokens, plens, cfg, cache)
        return logits.argmax(-1).to(torch.int32), cache

    return prefill_fn


def make_slot_decode_loop(cfg, k: int):
    """Macro-step: K greedy slot-decode steps with no host sync.

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
    """
    fam = get_family(cfg)

    def loop_fn(params, tokens, positions, remaining, eos_ids, done, cache):
        poison = torch.zeros_like(done)
        block, valid = [], []
        for _ in range(k):
            live = ~done
            logits, cache = fam.decode_step_slots(params, tokens, positions,
                                                  cache, cfg, done=done)
            bad = live & ~torch.isfinite(logits.float()).all(-1)
            live = live & ~bad
            poison = poison | bad
            nxt = logits.argmax(-1).to(torch.int32)
            tokens = torch.where(live, nxt, tokens)
            remaining = torch.where(live, remaining - 1, remaining)
            done = done | bad | (live & ((tokens == eos_ids)
                                         | (remaining <= 0)))
            positions = torch.where(live, positions + 1, positions)
            block.append(tokens)
            valid.append(live)
        return (torch.stack(block), torch.stack(valid), poison, tokens,
                positions, remaining, done, cache)

    return loop_fn
