"""Model zoo: family registry.

A family module exposes the same functional interface as in the reference
package:
  init(gen, cfg) -> params          (random, drawn from a torch.Generator)
  forward(params, batch, cfg) -> (logits, aux)
  init_cache / prefill / decode_step                    (decoders)
and, to serve through ``ContinuousBatchingEngine``, the slot-state
protocol:
  prefill_full(params, batch, cfg, cache) -> (logits (B, S, V), cache)
  prefill_last(params, tokens, plens, cfg, cache) -> (logits (B, V), cache)
  decode_step_slots(params, tokens, positions, cache, cfg, done=None)
  serve_supported(cfg) -> (ok, detail)
and, to run as a speculative draft or target, the chunk-verify hooks
(plus a head-less admission prefill for the draft pool):
  verify_step_slots(params, tokens, positions, cache, cfg, done=None)
  commit_slots(params, tokens, positions, n_feed, cache, pending, cfg,
               done=None)
  prefill_cache(params, tokens, cfg, cache) -> cache
and, to serve from a paged pool (``serve/paged.py``), the declaration of
its pageable cache groups:
  paged_groups(cfg) -> {group key: (kind, leaf names)}
The transformer and griffin families are ported so far; griffin has no
chunk-verify hooks, so it serves without speculation.
"""
from __future__ import annotations

import importlib

_FAMILIES = {
    "transformer": "repro_torch.models.transformer",
    "griffin": "repro_torch.models.griffin",
}


def get_family(cfg_or_name):
    name = getattr(cfg_or_name, "family", cfg_or_name)
    if name not in _FAMILIES:
        raise NotImplementedError(
            f"family {name!r} is not ported to repro_torch yet (see "
            "ROADMAP.md)")
    return importlib.import_module(_FAMILIES[name])


def serve_supported(cfg):
    """Capability probe: can ``ContinuousBatchingEngine`` serve this
    config?  Returns (ok, detail)."""
    if cfg.family not in _FAMILIES:
        return False, (f"family {cfg.family!r} is not ported to "
                       "repro_torch yet (see ROADMAP.md)")
    return get_family(cfg).serve_supported(cfg)


def paged_groups(cfg):
    """Slot-state protocol: which slot-cache groups page under a paged
    pool, ``{top-level cache key: ("seq", leaf names)}`` ("seq": the named
    (L, B, S, ...) leaves share one sequence axis that splits into pages,
    and every slot holds a block table).  An empty dict means nothing
    pages."""
    fam = get_family(cfg)
    probe = getattr(fam, "paged_groups", None)
    return probe(cfg) if probe else {}


def slot_cache_layout(cfg):
    """Short layout tag for telemetry: how a serve slot stores its state."""
    if cfg.family not in _FAMILIES:
        return "unsupported"
    return get_family(cfg).slot_cache_layout(cfg)


def spec_decode_supported(cfg):
    """Capability probe: can this config run as a speculative draft or
    target?  Requires the slot-state protocol plus the chunk-verify hooks
    (``verify_step_slots`` / ``commit_slots``)."""
    ok, detail = serve_supported(cfg)
    if not ok:
        return ok, detail
    fam = get_family(cfg)
    if not (hasattr(fam, "verify_step_slots")
            and hasattr(fam, "commit_slots")):
        return False, (f"family {cfg.family!r} does not implement the "
                       "chunk-verify (speculative) slot hooks")
    return True, detail
