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

from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.models import get_family, serve_supported
from repro_torch.serve import (
    POLICIES,
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
    SpeculativeConfig,
    spec_pair_supported,
)
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.utils.device import resolve_device

# reference-package flags this slice does not port yet: name -> what it is
UNPORTED_FLAGS = {
    "--grow-cfg": "live upgrade", "--upgrade-at": "live upgrade",
    "--upgrade-sync": "live upgrade", "--kernel": "the kernel switch (the device "
    "picks kernel or plain version)", "--mesh": "sharded serving",
    "--deadline": "deadlines", "--journal": "the request journal",
    "--resume": "the request journal", "--snapshot": "engine snapshots",
    "--faults": "fault injection",
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


def require_servable(cfg):
    ok, why = serve_supported(cfg)
    if not ok:
        raise SystemExit(
            f"error: --engine continuous cannot serve {cfg.name!r}: {why}")


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

    engine = ContinuousBatchingEngine(cfg, params, capacity=args.capacity,
                                      max_len=max_len, k=args.k,
                                      policy=args.policy, pool=args.pool,
                                      pages=args.pages or None,
                                      sampling=sampling,
                                      speculative=speculative)
    if engine.pages_budget is not None:
        arena = ("one arena shared by target and draft"
                 if speculative is not None else "target arena")
        note = (f"--pages {args.pages}" if args.pages
                else "default: the dense pool's footprint")
        print(f"[serve] page budget: {engine.pages_budget} pages, {arena} "
              f"({note})")
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.batch):
        plen = int(rng.integers(max(1, args.prompt_len // 2),
                                args.prompt_len + 1))
        prompt = lm_batch(cfg.vocab_size, 1, plen, seed=uid)[0]
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=args.gen, eos_id=args.eos_id))
    t0 = time.time()
    out = engine.run(reqs)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in out.values())
    mode = "speculative" if speculative is not None else "continuous"
    spec_note = "" if speculative is None else (
        f", draft={speculative.cfg.name} d={speculative.d} acceptance "
        f"{engine.acceptance_rate:.3f} ({engine.n_spec_accepted}/"
        f"{engine.n_spec_proposed}), {engine.n_spec_fallbacks} spec "
        "fallback(s)")
    paged_note = "" if engine.pool_kind != "paged" else (
        f", {engine.pages_budget} pages budget, {engine.pages_highwater} "
        f"pages peak ({engine._alloc.meta.page} tok/page), prefix hit rate "
        f"{engine.prefix_hit_rate:.2f}")
    print(f"[{mode}] {cfg.family}/{engine.cache_layout} "
          f"({engine.pool_kind} pool) on {dev} served {len(reqs)} requests "
          f"/ {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
          f"{engine.n_decode_dispatches} macro-steps of K={args.k}, "
          f"{engine.n_prefills} prefill batches, "
          f"{engine.n_host_syncs / max(n_tok, 1):.2f} host syncs/token"
          f"{spec_note}{paged_note})")
    if engine.rejected:
        print(f"[continuous] rejected {len(engine.rejected)} request(s):")
        for uid, why in sorted(engine.rejected.items()):
            print(f"  uid {uid}: {why}")
    for uid in sorted(out)[:2]:
        print(uid, out[uid])


if __name__ == "__main__":
    main()
