"""Serving launcher: naive lock-step batch or continuous batching.

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent:

  # naive fixed-batch greedy loop
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --batch 4 --prompt-len 128 --gen 32

  # continuous batching over a dense slot pool
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --batch 16 --capacity 8 --max-len 1024

  # the same on the CPU at a small size
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-micro \
      --engine continuous --batch 4 --gen 8 --device cpu

  # serve a model grown from a source arch by the paper's operator
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --grow gpt-small --grow-method mango --grow-steps 3

  # speculative serving: the pretrained SOURCE drafts for its grown target
  # (with --grow the source is the draft; --draft picks another config of
  # the same vocabulary, freshly initialised)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --grow gpt-small --speculate --spec-d 4

  # sampled decode: temperature / top-k / top-p over per-request chains
  # seeded from (--sample-seed, uid); speculation then rejection-samples
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --temperature 0.8 --top-k 50 --top-p 0.95

  # the paged pool: block tables over one page arena of --pages pages
  # (shared by target and draft with --speculate), prefix sharing
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --pool paged --pages 64 --max-len 1024

  # griffin (recurrentgemma-2b): recurrent state per slot beside
  # ring-buffer window caches, which page on a paged pool
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-2b --engine continuous --batch 16 \
      --capacity 8 --prompt-len 2048 --gen 64 --max-len 4096 \
      --pool paged --pages 160

  # live upgrade: serve gpt-small, grow it into gpt-base with Mango while
  # serving (--upgrade-sync grows first), hot-swap at dispatch 2; the old
  # source then drafts for its grown target
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-small \
      --engine continuous --batch 16 --capacity 8 --gen 64 \
      --grow-cfg gpt-base --upgrade-at 2

  # crash safety: a request journal and an engine snapshot; after a crash
  # --resume replays the journal (mid-flight requests re-admit as prompt
  # followed by their committed tokens, finished ones are not re-run)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --journal j.jsonl --snapshot snap/
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --journal j.jsonl --resume

  # xlstm (xlstm-1.3b): O(1) recurrent state per slot (mLSTM C/n/m, sLSTM
  # carries); on a paged pool the conv tails page, one page a slot; a
  # nudged or self draft speculates through per-step state snapshots
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --engine continuous --batch 8 --capacity 8 --prompt-len 512 \
      --gen 64 --max-len 640 --pool paged --pages 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --engine continuous --speculate --draft xlstm-1.3b --spec-d 3 --k 2

  # griffin speculation: recurrentgemma-2b drafting for itself (the
  # verify runs the slot decode over each chunk; d + 1 must fit the window)
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-2b --engine continuous --speculate \
      --draft recurrentgemma-2b --spec-d 4 --k 2 --prompt-len 512 --gen 64

  # the fault layer: a per-request deadline and a fault plan (kind@step
  # with kinds nan/oom/slow/hang/malformed/crash; the report names every
  # request that did not finish); a crash leaves the journal to --resume
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --deadline 30 --faults nan@2,oom@3:2,slow@4:0.05
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-base \
      --engine continuous --journal j.jsonl --faults crash@3

  # a RoPE decoder (qwen3-0.6b, bf16 as published): naive generate, whose
  # decode steps run the decode_attention kernel, then the engine
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --engine continuous --batch 16 --capacity 8 --prompt-len 768 \
      --gen 64 --max-len 1024 --pool paged --pages 64
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.data import lm_batch
from repro_torch.models import get_family, serve_supported
from repro_torch.serve import (
    POLICIES,
    ContinuousBatchingEngine,
    EngineKilled,
    FaultPlan,
    Request,
    RequestJournal,
    SamplingParams,
    SpeculativeConfig,
    UpgradeError,
    UpgradeManager,
    read_journal,
    recovery_requests,
    snapshot_engine,
    spec_pair_supported,
)
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.utils.device import resolve_device

# reference-package flags the port does not take yet: name -> what it is
UNPORTED_FLAGS = {
    "--kernel": "the kernel switch (the device picks kernel or plain "
    "version)", "--mesh": "sharded serving",
}


def generate(cfg, params, prompt_tokens, *, max_new_tokens=16,
             max_len=None, eos_id=None):
    """prompt_tokens: (B, P) int tensor -> (B, <=max_new_tokens) greedy
    tokens, on the prompt's device.

    ``eos_id`` enables per-row early stopping: a row that emits eos is
    frozen (later entries clamp to eos) and the loop exits as soon as
    every row has fired.
    """
    fam = get_family(cfg)
    B, P = prompt_tokens.shape
    max_len = max_len or (P + max_new_tokens)
    cache = fam.init_cache(cfg, B, max_len, device=prompt_tokens.device)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    logits, cache = prefill(params, {"tokens": prompt_tokens}, cache)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    done = None if eos_id is None else (tok == eos_id)
    for t in range(max_new_tokens - 1):
        if done is not None and bool(done.all()):
            break
        tok, cache = decode(params, tok, P + t, cache)
        if done is not None:
            tok = torch.where(done, eos_id, tok)  # freeze finished rows
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)


def build_params(cfg, *, grow_from=None, grow_method="mango", grow_rank=1,
                 grow_steps=0, seed=0, device="cuda", log_fn=print,
                 return_source=False):
    """Params for ``cfg`` on ``device``: random, drawn from a
    ``torch.Generator`` seeded with ``seed``, or grown from the source arch
    ``grow_from`` through the paper's operator (``core/grow.py``), whose
    training (``grow_steps`` > 0) runs on synthetic 4 x 32 token batches.

    ``return_source=True`` returns ``(params, cfg_src, params_src)``: the
    source the target was grown from, which is the draft speculative
    serving wants (``cfg_src`` / ``params_src`` are None without
    ``grow_from``)."""
    dev = resolve_device(device)
    if not grow_from:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = get_family(cfg).init(gen, cfg)
        return (params, None, None) if return_source else params

    from repro_torch.core import grow as growlib
    from repro_torch.data import lm_data_iter

    cfg_src = get_config(grow_from)
    params, params_src = growlib.grow_from_source(
        cfg_src, cfg, method=grow_method, rank=grow_rank, steps=grow_steps,
        data_iter=lm_data_iter(cfg.vocab_size, 4, 32, seed=seed + 1),
        seed=seed, device=dev, log_fn=log_fn, return_source=True)
    return (params, cfg_src, params_src) if return_source else params


def trace_requests(cfg, n, prompt_len, gen, eos_id=None, skip=()):
    """The continuous launcher's trace: ``n`` requests (uids 0..n-1, those
    in ``skip`` left out), prompts of ``prompt_len // 2 .. prompt_len``
    tokens (lengths from a generator seeded 0, tokens from
    ``lm_batch(seed=uid)``), ``gen`` new tokens each."""
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        if uid in skip:
            continue  # a resume already owns this uid
        prompt = lm_batch(cfg.vocab_size, 1, plen, seed=uid)[0]
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=gen,
                            eos_id=eos_id))
    return reqs


def require_servable(cfg):
    """Refuse a config the continuous engine cannot serve, naming the
    families and registered configs it can (the reference's text)."""
    ok, why = serve_supported(cfg)
    if ok:
        return

    def probe(name):
        try:
            return serve_supported(get_config(name))[0]
        except Exception:
            return False

    servable = [n for n in list_configs() if probe(n)]
    raise SystemExit(
        f"error: --engine continuous cannot serve {cfg.name!r}: {why}\n"
        "The slot-decode protocol serves causal decoder configs of every "
        "family in the zoo:\n"
        "  transformer — full KV, MLA latent, and ring-buffer window "
        "caches;\n"
        "  griffin     — rglru/conv recurrent state + local-attention "
        "rings;\n"
        "  xlstm       — mLSTM/sLSTM recurrent state.\n"
        f"Servable registered configs: {', '.join(servable)}\n"
        "(--engine naive runs any decoder config lock-step.)")


def require_spec_servable(cfg_tgt, cfg_draft, d, max_len):
    """Gate ``--speculate`` behind the PAIR probe: both models must serve
    through the chunk-verify slot protocol and share a vocabulary.  The
    probe's detail names the failing side."""
    ok, why = spec_pair_supported(cfg_tgt, cfg_draft, d, max_len)
    if ok:
        print(f"[serve] speculative pair: {why}")
        return
    raise SystemExit(
        f"error: --speculate cannot serve this draft/target pair: {why}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            raise SystemExit(f"error: {flag} ({UNPORTED_FLAGS[flag]}) is not "
                             "ported to repro_torch yet (see ROADMAP.md)")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--engine", default="naive",
                    choices=["naive", "continuous"])
    ap.add_argument("--batch", type=int, default=4,
                    help="naive: batch size; continuous: request count")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=4,
                    help="continuous: decode slot-pool size")
    ap.add_argument("--max-len", type=int, default=0,
                    help="continuous: per-slot cache length (0 = auto)")
    ap.add_argument("--k", type=int, default=8,
                    help="continuous: macro-step length (decode tokens per "
                         "dispatch; the host syncs once per dispatch)")
    ap.add_argument("--policy", default="fifo", choices=list(POLICIES),
                    help="admission policy: fifo, or spf (length-bucketed "
                         "shortest-prefill-first)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a sequence early when it emits this token")
    ap.add_argument("--grow", default=None, metavar="SRC_ARCH",
                    help="grow params from this source arch before serving")
    ap.add_argument("--grow-method", default="mango",
                    choices=["mango", "ligo", "bert2bert", "stackbert",
                             "net2net"])
    ap.add_argument("--grow-rank", type=int, default=1)
    ap.add_argument("--grow-steps", type=int, default=0)
    ap.add_argument("--pool", default="dense", choices=["dense", "paged"],
                    help="continuous: slot-pool layout, dense (one full "
                         "max_len row per slot) or paged (block tables over "
                         "a shared page arena, with a prefix cache)")
    ap.add_argument("--pages", type=int, default=0,
                    help="paged: page-arena depth (0 = capacity * blocks "
                         "per slot, the dense pool's footprint)")
    ap.add_argument("--speculate", action="store_true",
                    help="greedy speculative decode: a draft model proposes, "
                         "the target verifies (needs --draft, or --grow whose "
                         "source then drafts)")
    ap.add_argument("--draft", default=None, metavar="DRAFT_ARCH",
                    help="draft config for --speculate (default: the --grow "
                         "source)")
    ap.add_argument("--spec-d", type=int, default=4,
                    help="speculation depth: draft proposals per block")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy; implied 1.0 "
                         "when only --top-k/--top-p are set)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--grow-cfg", default=None, metavar="TGT_ARCH",
                    help="continuous: LIVE upgrade -- Mango-grow --arch into "
                         "this target while serving, then hot-swap the "
                         "grown weights into the running engine with zero "
                         "dropped requests (mid-flight sequences continue "
                         "token-exactly; the old source becomes the "
                         "speculative draft when the pair probe passes).  "
                         "Growth method/rank/steps follow "
                         "--grow-method/--grow-rank/--grow-steps")
    ap.add_argument("--upgrade-at", type=int, default=0,
                    help="with --grow-cfg: least number of decode dispatches "
                         "before the hot swap may land (0 = the first block "
                         "boundary after growth is ready)")
    ap.add_argument("--upgrade-sync", action="store_true",
                    help="with --grow-cfg: grow BEFORE serving starts "
                         "instead of on a background thread, so the swap "
                         "lands at --upgrade-at deterministically")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="continuous: per-request TTL in seconds -- the "
                         "watchdog evicts a request this long after its "
                         "arrival with outcome 'expired' (0 = off)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="continuous: append-only crash-safe request "
                         "journal (JSONL); committed tokens flush at "
                         "block-readback granularity")
    ap.add_argument("--resume", action="store_true",
                    help="replay --journal before serving: mid-flight "
                         "requests re-admit token-exactly (prompt followed "
                         "by the committed tokens), finished ones are not "
                         "re-run")
    ap.add_argument("--snapshot", default=None, metavar="DIR",
                    help="continuous: write an engine snapshot (weights + "
                         "geometry, checkpoint format) before serving; "
                         "serve.recovery.restore_engine rebuilds the "
                         "engine from it")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="continuous: deterministic fault injection -- "
                         "'kind@step[:arg],...' with kinds "
                         "nan/oom/slow/hang/malformed/crash, or "
                         "'seed:S[:N]' for a seeded random plan "
                         "(chaos testing; see serve/faults.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.engine == "continuous":
        require_servable(cfg)
    sampling = None
    if args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0:
        # any non-default sampling flag samples: --top-k/--top-p alone
        # would otherwise be greedy (temperature 0 means greedy)
        temperature = args.temperature if args.temperature > 0 else 1.0
        if args.temperature <= 0:
            print("[serve] --top-k/--top-p without --temperature: "
                  "sampling at temperature 1.0")
        sampling = SamplingParams(temperature=temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.sample_seed)
    if args.engine == "naive" and (sampling is not None
                                   or args.policy != "fifo"):
        # greedy lock-step output while the user asked for sampling would
        # misrepresent the output
        raise SystemExit("error: --temperature/--top-k/--top-p/--policy "
                         "require --engine continuous (the naive loop is "
                         "greedy lock-step)")
    if args.engine != "continuous" and (args.pool != "dense" or args.pages):
        raise SystemExit("error: --pool/--pages require --engine "
                         "continuous (the naive loop has no slot pool)")
    if args.engine == "naive" and (args.deadline or args.journal
                                   or args.resume or args.faults
                                   or args.snapshot):
        # the reference's text
        raise SystemExit("error: --deadline/--journal/--resume/--snapshot/"
                         "--faults require --engine continuous (the fault "
                         "tolerance layer lives in the slot-pool engine)")
    if args.resume and not args.journal:
        raise SystemExit("error: --resume needs --journal PATH (the "
                         "journal IS the recovery record)")
    if args.grow_cfg and args.engine != "continuous":
        raise SystemExit("error: --grow-cfg requires --engine continuous "
                         "(a live upgrade hot-swaps the slot-pool "
                         "engine)")
    if (args.upgrade_at or args.upgrade_sync) and not args.grow_cfg:
        raise SystemExit("error: --upgrade-at/--upgrade-sync need "
                         "--grow-cfg TGT_ARCH (they schedule the live "
                         "upgrade)")
    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.speculate:
        if args.engine != "continuous":
            raise SystemExit("error: --speculate requires --engine "
                             "continuous")
        draft_name = args.draft or args.grow
        if draft_name is None:
            raise SystemExit("error: --speculate needs a draft model — "
                             "pass --draft ARCH, or --grow SRC (the "
                             "pretrained source then drafts for its grown "
                             "target)")
        # probe the PAIR before any param init or growth
        require_spec_servable(cfg, get_config(draft_name), args.spec_d,
                              max_len)
    params, cfg_src, params_src = build_params(
        cfg, grow_from=args.grow, grow_method=args.grow_method,
        grow_rank=args.grow_rank, grow_steps=args.grow_steps, device=dev,
        return_source=True)
    speculative = None
    if args.speculate:
        if args.draft and (cfg_src is None or args.draft != cfg_src.name):
            cfg_d = get_config(args.draft)
            params_d = get_family(cfg_d).init(
                torch.Generator(device=dev).manual_seed(0), cfg_d)
        else:
            # the paper's pair: the source the target was grown from drafts
            cfg_d, params_d = cfg_src, params_src
        speculative = SpeculativeConfig(cfg_d, params_d, d=args.spec_d)

    if args.engine == "naive":
        prompts = torch.from_numpy(
            lm_batch(cfg.vocab_size, args.batch, args.prompt_len)).to(dev)
        t0 = time.time()
        toks = generate(cfg, params, prompts, max_new_tokens=args.gen,
                        eos_id=args.eos_id).cpu().numpy()
        dt = time.time() - t0
        if args.eos_id is None:
            n_tok = toks.size
        else:
            fired = toks == args.eos_id
            n_tok = sum(int(np.argmax(r)) + 1 if r.any() else len(r)
                        for r in fired)
        print(f"[naive] generated {n_tok} tokens ({args.batch}x<="
              f"{toks.shape[1]}) on {dev} in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s)")
        print(toks[:2])
        return

    recovered, resumed = {}, []
    if args.resume:
        st = read_journal(args.journal)
        resumed, recovered = recovery_requests(st)
        print(f"[serve] --resume: journal replays {len(st.order)} "
              f"request(s) — {len(recovered)} already complete, "
              f"{len(resumed)} re-admitting mid-flight")
    journal = RequestJournal(args.journal) if args.journal else None
    faults = FaultPlan.parse(args.faults) if args.faults else None
    engine = ContinuousBatchingEngine(cfg, params, capacity=args.capacity,
                                      max_len=max_len, k=args.k,
                                      policy=args.policy, pool=args.pool,
                                      pages=args.pages or None,
                                      sampling=sampling,
                                      speculative=speculative,
                                      deadline=args.deadline or None,
                                      journal=journal, faults=faults)
    if engine.pages_budget is not None:
        arena = ("one arena shared by target and draft"
                 if speculative is not None else "target arena")
        note = (f"--pages {args.pages}" if args.pages
                else "default: the dense pool's footprint")
        print(f"[serve] page budget: {engine.pages_budget} pages, {arena} "
              f"({note})")
    if args.snapshot:
        path = snapshot_engine(engine, args.snapshot)
        print(f"[serve] engine snapshot -> {path}")
    upgrade = None
    if args.grow_cfg:
        try:
            upgrade = UpgradeManager(
                engine, get_config(args.grow_cfg), method=args.grow_method,
                rank=args.grow_rank, grow_steps=args.grow_steps,
                spec_d=args.spec_d, upgrade_at=args.upgrade_at,
                probe_fp=True)
        except UpgradeError as e:
            raise SystemExit(f"error: --grow-cfg: {e}")
        upgrade.start(background=not args.upgrade_sync)
        how = "pre-grown" if args.upgrade_sync else "growing in background"
        print(f"[serve] live upgrade armed: {cfg.name} -> "
              f"{upgrade.cfg_tgt.name} ({how}, swap at dispatch "
              f">= {args.upgrade_at})")
    reqs = resumed + trace_requests(
        cfg, args.batch, args.prompt_len, args.gen, args.eos_id,
        skip={r.uid for r in resumed} | set(recovered))
    t0 = time.time()
    try:
        out = engine.run(reqs)
    except EngineKilled as e:
        # the injected crash: the journal survived, the process "died";
        # exit cleanly so a restart can resume it
        if journal is not None:
            journal.close()
        print(f"[serve] ENGINE KILLED ({e}) — journal at {args.journal} "
              "holds the committed state; rerun with --resume")
        return
    dt = time.time() - t0
    if upgrade is not None:
        if upgrade.state in ("growing", "ready"):
            # the trace ended before the background growth was ready: land
            # the swap now, so the next trace serves the target
            upgrade.wait()
            upgrade.poll(engine)
            print("[serve] upgrade: growth outlived the trace — swap "
                  "landed at trace end")
        if upgrade.state == "swapped":
            spec = (f"draft={upgrade.cfg_src.name} d={upgrade.spec_d}"
                    if engine.speculative is not None else
                    f"off ({upgrade.spec_reason})")
            fp = upgrade.fp_token_agreement
            page_note = ""
            if upgrade.pages_resident_at_swap:
                page_note = (
                    f", pages {upgrade.pages_carried} carried / "
                    f"{upgrade.pages_reprefilled} re-prefilled "
                    f"({upgrade.pages_resident_at_swap} resident at swap)")
            print(f"[serve] upgrade SWAPPED: {upgrade.cfg_src.name} -> "
                  f"{upgrade.cfg_tgt.name} in {upgrade.grow_seconds:.1f}s "
                  f"growth, {upgrade.prewarm_seconds or 0:.1f}s prewarm, "
                  f"pause {upgrade.pause_ms:.0f} ms, {upgrade.resumed} "
                  f"mid-flight resumed, {engine.n_held_for_upgrade} held "
                  f"submits, {len(engine.rejected)} dropped{page_note}; "
                  f"greedy agreement "
                  f"{'n/a' if fp is None else f'{fp:.3f}'}; post-swap "
                  f"speculation {spec}")
        elif upgrade.state == "failed":
            print(f"[serve] upgrade FAILED (engine kept serving "
                  f"{cfg.name}): {upgrade.error}")
    out = {**recovered, **out}
    n_tok = sum(len(v) for v in out.values())
    spec_eng = engine.speculative
    mode = "speculative" if spec_eng is not None else "continuous"
    spec_note = "" if spec_eng is None else (
        f", draft={spec_eng.cfg.name} d={spec_eng.d} acceptance "
        f"{engine.acceptance_rate:.3f} ({engine.n_spec_accepted}/"
        f"{engine.n_spec_proposed}), {engine.n_spec_fallbacks} spec "
        "fallback(s)")
    paged_note = "" if engine.pool_kind != "paged" else (
        f", {engine.pages_budget} pages budget, {engine.pages_highwater} "
        f"pages peak ({engine._alloc.meta.page} tok/page), prefix hit rate "
        f"{engine.prefix_hit_rate:.2f}")
    print(f"[{mode}] {engine.cfg.family}/{engine.cache_layout} "
          f"({engine.pool_kind} pool) on {dev} served {len(reqs)} requests "
          f"/ {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
          f"{engine.n_decode_dispatches} macro-steps of K={args.k}, "
          f"{engine.n_prefills} prefill batches, "
          f"{engine.n_host_syncs / max(n_tok, 1):.2f} host syncs/token"
          f"{spec_note}{paged_note})")
    if engine.rejected:
        print(f"[{mode}] rejected {len(engine.rejected)} request(s):")
        for uid, why in sorted(engine.rejected.items()):
            print(f"  uid {uid}: {why}")
    bad = {u: o for u, o in engine.outcomes.items() if o != "finished"}
    if bad or engine.n_faults_injected:
        print(f"[{mode}] fault report: {engine.n_faults_injected} "
              f"fault(s) injected, {engine.n_expired} expired, "
              f"{engine.n_quarantined} quarantined, {engine.n_shed} shed, "
              f"{engine.n_spec_fallbacks} spec fallback(s), "
              f"{engine.n_degraded_admissions} degraded admission(s)")
        for uid, o in sorted(bad.items()):
            print(f"  uid {uid}: {o}")
    if journal is not None:
        journal.close()
    for uid in sorted(out)[:2]:
        print(uid, out[uid])


if __name__ == "__main__":
    main()
