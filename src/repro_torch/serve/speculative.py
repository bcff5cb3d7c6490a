"""Speculative decoding for the continuous-batching engine.

The paper grows every target weight as a (multi-)linear function of the
pretrained source weights, which makes the small source model a
well-matched DRAFT for its grown target at serve time:

  * the draft proposes ``d`` tokens per slot with its own slot-decode
    steps (the slot-decode kernel on the card);
  * the target verifies the carried token and the ``d`` proposals in ONE
    batched chunk forward (``verify_step_slots``, the chunk-verify kernel),
    giving its own next-token choice after every chunk prefix;
  * the longest accepted prefix is committed per slot into both pools
    (``commit_slots``); the draft first catches up on the committed chunk
    through its own verify (the same kernel), so both pools agree on every
    committed position;
  * per-slot eos / budget stopping is folded into the acceptance mask, so
    a slot that finishes mid-chunk freezes exactly there, as in the macro
    decode loop.

Every emitted token is the target's own argmax after its committed prefix,
so greedy speculative decode gives the tokens of non-speculative
``generate()``; acceptance only decides how many one block emits.  Under a
non-greedy ``SamplingParams`` the draft samples its proposals and the
target accepts each by rejection sampling (accept ``x ~ q`` with
probability ``min(1, p(x) / q(x))``, else redraw from ``max(p - q, 0)``),
so every emitted token follows the target's filtered distribution.

The draft's proposals write the draft pool IN PLACE, past each row's
committed length (the reference package proposes on a functional copy of
the pool; a copy of gpt-small's pool at capacity 8 and max_len 1024 is
~400 MB per block).  The catch-up commit then overwrites
``[pos, pos + n_feed)``, and the scratch K/V beyond it is never read: on
the full layout every read stops at ``kv_len = position + 1`` and the next
block's proposal j writes position ``pos + j`` before any step reads it.
That holds for the full layout only.  A recurrent draft's proposals
advance its state irreversibly and a ring draft's overwrite committed ring
sites, so such a family (griffin, xlstm; the transformer, for a windowed
draft) exposes ``snapshot_slots`` / ``restore_slots``: the block keeps the
draft's O(1) recurrent state (xlstm's whole slot state: C/n/m, sLSTM
carries, conv tails) and the d ring sites the proposals write, and puts
them back before the catch-up.

``make_speculative_loop(cfg_t, cfg_d, d, k)`` runs ``k`` whole
draft→verify→commit blocks per dispatch as a Python loop that never reads
a value back to the host, so a dispatch emits up to ``k * (d + 1)`` tokens
per slot with one host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import get_family, spec_decode_supported
from repro_torch.serve import sampling as sampling_lib


@dataclasses.dataclass
class SpeculativeConfig:
    """Draft-side configuration for a speculative engine.

    ``cfg``/``params`` are the draft model (typically the pretrained
    source the target was grown from); ``d`` is the speculation depth:
    draft proposals per block, so a block commits between 1 and ``d + 1``
    tokens per live slot.
    """
    cfg: Any
    params: Any
    d: int = 4


def spec_pair_supported(cfg_target, cfg_draft, d: int = 4,
                        max_len: Optional[int] = None):
    """Capability probe for a speculative (target, draft) PAIR.

    Returns (ok, detail).  ``detail`` reports servability for BOTH models:
    a pair serves speculatively only when each side passes its own probe,
    implements the chunk-verify hooks, and the two share a vocabulary;
    ring-buffer layouts also need the ``d + 1``-token verify chunk to fit
    their ring.
    """
    if d < 1:
        return False, f"speculation depth d must be >= 1 (got {d})"
    ok_t, det_t = spec_decode_supported(cfg_target)
    ok_d, det_d = spec_decode_supported(cfg_draft)
    per_mode = (f"target {cfg_target.name!r}: "
                f"{'ok — ' if ok_t else 'NOT SERVABLE — '}{det_t}; "
                f"draft {cfg_draft.name!r}: "
                f"{'ok — ' if ok_d else 'NOT SERVABLE — '}{det_d}")
    if not (ok_t and ok_d):
        return False, per_mode
    if cfg_target.vocab_size != cfg_draft.vocab_size:
        return False, (f"draft/target vocabularies differ "
                       f"({cfg_draft.vocab_size} vs "
                       f"{cfg_target.vocab_size}) — draft proposals would "
                       "not index the target distribution")
    for role, cfg in (("target", cfg_target), ("draft", cfg_draft)):
        ring = min(cfg.window, max_len) if (cfg.window and max_len) \
            else cfg.window
        if ring and d + 1 > ring:
            return False, (f"{role} {cfg.name!r}: verify chunk d+1={d + 1} "
                           f"overruns its ring-buffer window ({ring}) — "
                           "a chunk position would wrap onto a committed "
                           "slot")
    return True, per_mode


def make_draft_prefill(cfg_d):
    """Admission prefill for the DRAFT pool: the same bucket-padded prompt
    batch as the target's admission.  Only the per-row prompt state
    matters (the first generated token is the target's), so no head runs.

    fn(params_d, tokens (N, Sbucket), plens (N,), cache) -> cache
    """
    fam = get_family(cfg_d)

    def prefill_fn(params_d, tokens, plens, cache):
        # a recurrent state and a ring need each row's true length; a
        # full cache hides the pad tail behind it
        return fam.prefill_cache(params_d, tokens, cfg_d, cache,
                                 plens=plens)

    return prefill_fn


def _non_finite_rows(logits):
    """(B, ..., V) logits -> (B,) bool: any non-finite entry in the row."""
    return ~torch.isfinite(logits.float()).flatten(1).all(-1)


def make_speculative_loop(cfg_t, cfg_d, d: int, k: int, sampling=None):
    """K speculative blocks per dispatch: the engine's macro-step in
    speculative mode.

    fn(params_t, params_d, tokens (B,), positions (B,), remaining (B,),
       eos_ids (B,), done (B,), pool_t, pool_d) ->
        (block (K*(d+1), B) int32, valid (K*(d+1), B) bool,
         poison (B,) bool, draft_bad () bool,
         tokens, positions, remaining, done, pool_t, pool_d,
         n_proposed () int, n_accepted () int)

    Block semantics mirror ``make_slot_decode_loop``: ``valid[i, b]``
    marks really-committed tokens, rows emit eos as valid then go quiet,
    finished rows are no-ops.  ``n_proposed`` / ``n_accepted`` count the
    draft tokens offered / accepted across the dispatch (proposals past a
    row's budget are not offered), as device tensors that ride the block's
    readback.  ``poison[b]`` flags a row whose TARGET verify logits came
    back non-finite: it commits nothing that block and freezes, and the
    engine quarantines it.  A broken draft cannot change greedy output
    (bad proposals are merely rejected), so under greedy ``draft_bad``
    only reports non-finite draft logits; the engine then drops to plain
    macro decode.  Pools are updated in place.

    With a non-greedy ``sampling`` the signature gains per-slot chains --
    fn(..., pool_d, keys (B, 2)) -> (..., pool_d, keys, n_proposed,
    n_accepted) -- advanced once a block for live rows.  Block key
    ``kb``: draft draw j uses ``fold_in(kb, j)``, the d acceptance
    uniforms ``fold_in(kb, d)``, the S replacement draws ``fold_in(kb, d +
    1)`` over (S, V).  A row whose DRAFT logits went non-finite is
    poisoned too: its rejection sampling would no longer follow the
    target's distribution.
    """
    fam_t, fam_d = get_family(cfg_t), get_family(cfg_d)
    # families whose proposals overwrite committed state (griffin's
    # recurrence and rings, xlstm's recurrence, a windowed transformer's
    # ring); a full-KV or full latent (MLA) draft keeps nothing
    snapshot = (None if fam_d.slot_cache_layout(cfg_d) in ("full",
                                                          "full-mla")
                else getattr(fam_d, "snapshot_slots", None))
    greedy = sampling_lib.is_greedy(sampling)
    S = d + 1

    def accept_sampled(chunk, logits_t, qs, kblock):
        """Rejection sampling: (accepted (B, d), out_tokens (B, S))."""
        B, V = chunk.shape[0], logits_t.shape[-1]
        p = sampling_lib.filtered_probs(logits_t.reshape(B * S, V),
                                        sampling).reshape(B, S, V)
        x = chunk[:, 1:].long()  # (B, d) draft proposals
        p_x = p[:, :-1].gather(-1, x[..., None])[..., 0]
        q_x = qs.gather(-1, x[..., None])[..., 0]
        u = sampling_lib.uniform(sampling_lib.fold_in(kblock, d), (d,))
        match = u < (p_x / q_x.clamp_min(1e-38)).clamp_max(1.0)
        # replacements: the residual distribution at each rejection point;
        # the all-accepted bonus draws from the target's own last one
        repl_dists = torch.cat(
            [sampling_lib.residual_probs(p[:, :-1], qs), p[:, -1:]], 1)
        logp = torch.where(repl_dists > 0,
                           torch.log(repl_dists.clamp_min(1e-38)),
                           sampling_lib.NEG_INF)
        repl = sampling_lib.categorical(
            sampling_lib.fold_in(kblock, d + 1), logp).to(torch.int32)
        out_tokens = torch.where(
            torch.cat([match, torch.zeros_like(match[:, :1])], 1),
            torch.cat([chunk[:, 1:], torch.zeros_like(chunk[:, :1])], 1),
            repl)
        return match, out_tokens

    def one_block(params_t, params_d, tokens, positions, remaining, eos_ids,
                  done, pool_t, pool_d, keys):
        B = tokens.shape[0]
        live0 = ~done
        # a row owing R more tokens can accept at most min(d, R - 1)
        # drafts (the block's last output is always the target's own), so
        # budget clipping does not read as rejection in the telemetry
        n_prop_rows = torch.where(live0, (remaining - 1).clamp(0, d), 0)

        if not greedy:
            advanced, kblock = sampling_lib.next_keys(keys)
            keys = torch.where(live0[:, None], advanced, keys)
        # draft proposals, written into the draft pool in place (module
        # docstring); done rows keep their token.  Sampled, draw j uses
        # fold_in(kblock, j) and keeps its distribution q_j.  A draft with
        # recurrent state or rings first keeps what the proposals
        # overwrite, and gets it back before its catch-up
        snap = None if snapshot is None else snapshot(pool_d, positions, d)
        tok, dbad, drafts, qs = tokens, torch.zeros_like(done), [], []
        for j in range(d):
            logits, pool_d = fam_d.decode_step_slots(
                params_d, tok, positions + j, pool_d, cfg_d, done=done)
            dbad = dbad | (live0 & _non_finite_rows(logits))
            if greedy:
                nxt = logits.argmax(-1).to(torch.int32)
            else:
                qs.append(sampling_lib.filtered_probs(logits, sampling))
                nxt = sampling_lib.sample_probs(
                    qs[-1], sampling_lib.fold_in(kblock, j))
            tok = torch.where(done, tok, nxt)
            drafts.append(tok)
        if snap is not None:
            pool_d = fam_d.restore_slots(pool_d, snap, positions, d)
            del snap  # an xlstm draft's is its whole state: free it now
        chunk = torch.stack([tokens, *drafts], 1)  # (B, S)
        logits_t, pend_t = fam_t.verify_step_slots(
            params_t, chunk, positions, pool_t, cfg_t, done=done)
        if greedy:
            bad = live0 & _non_finite_rows(logits_t)
            out_tokens = logits_t.argmax(-1).to(torch.int32)  # (B, S)
            # proposal j survives iff it IS the target's argmax after the
            # accepted prefix, so every emitted token is the target's own
            match = chunk[:, 1:] == out_tokens[:, :-1]
        else:
            bad = live0 & (_non_finite_rows(logits_t) | dbad)
            match, out_tokens = accept_sampled(chunk, logits_t,
                                               torch.stack(qs, 1), kblock)

        # output j (1-based) is committed iff the row is live, proposals
        # 1..j-1 were all accepted, the budget still owes >= j tokens and
        # no earlier output of this block was the row's eos
        acc_ok = torch.cat([torch.ones_like(match[:, :1]),
                            torch.cumsum(~match, 1) == 0], 1)
        steps = torch.arange(1, S + 1, dtype=remaining.dtype,
                             device=remaining.device)
        budget_ok = steps[None] <= remaining[:, None]
        is_eos = out_tokens == eos_ids[:, None]
        no_eos_before = (torch.cumsum(is_eos, 1) - is_eos.int()) == 0
        alive = live0 & ~bad
        valid = alive[:, None] & acc_ok & budget_ok & no_eos_before
        n_out = valid.sum(1).to(torch.int32)
        last_idx = (n_out - 1).clamp(min=0).long()[:, None]
        last_tok = out_tokens.gather(1, last_idx)[:, 0]
        tokens = torch.where(alive, last_tok, tokens)
        remaining = torch.where(alive, remaining - n_out, remaining)
        fired_eos = is_eos.gather(1, last_idx)[:, 0]
        done_next = done | bad | (alive & (fired_eos | (remaining <= 0)))

        # commit the accepted prefix into BOTH pools: the carried token
        # and the accepted proposals (the last output is the next block's
        # carried token, or the row just finished)
        n_feed = torch.where(done | bad, 0, n_out)
        pool_t = fam_t.commit_slots(params_t, chunk, positions, n_feed,
                                    pool_t, pend_t, cfg_t, done=done)
        # a recurrent target's pending state is d + 2 copies of its pool:
        # freed before the draft's catch-up stacks its own
        del pend_t
        # draft catch-up: the draft consumes the same committed chunk
        # through its own verify, including the position its proposals
        # never fed
        _, pend_d = fam_d.verify_step_slots(params_d, chunk, positions,
                                            pool_d, cfg_d, done=done,
                                            logits=False)
        pool_d = fam_d.commit_slots(params_d, chunk, positions, n_feed,
                                    pool_d, pend_d, cfg_d, done=done)
        positions = positions + n_out
        n_acc = (n_out - 1).clamp(min=0).sum()
        return (out_tokens.T, valid.T, bad, dbad.any(), tokens, positions,
                remaining, done_next, pool_t, pool_d, keys,
                n_prop_rows.sum(), n_acc)

    def loop_fn(params_t, params_d, tokens, positions, remaining, eos_ids,
                done, pool_t, pool_d, keys=None):
        blocks, valids = [], []
        poison = torch.zeros_like(done)
        draft_bad = torch.zeros((), dtype=torch.bool, device=done.device)
        n_prop = torch.zeros((), dtype=torch.int64, device=done.device)
        n_acc = torch.zeros_like(n_prop)
        for _ in range(k):
            (block, valid, bad, dbad, tokens, positions, remaining, done,
             pool_t, pool_d, keys, prop, acc) = one_block(
                params_t, params_d, tokens, positions, remaining, eos_ids,
                done, pool_t, pool_d, keys)
            blocks.append(block)
            valids.append(valid)
            poison = poison | bad
            draft_bad = draft_bad | dbad
            n_prop = n_prop + prop
            n_acc = n_acc + acc
        out = (torch.cat(blocks), torch.cat(valids), poison, draft_bad,
               tokens, positions, remaining, done, pool_t, pool_d)
        return (*out, n_prop, n_acc) if greedy else (*out, keys, n_prop,
                                                      n_acc)

    return loop_fn
