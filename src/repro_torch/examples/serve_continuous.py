"""Continuous-batching serving example.

A stream of requests with mixed prompt lengths and mixed generation
lengths flows through a fixed-capacity slot pool: sequences are admitted
as slots free up, decode runs as ONE batched step per engine iteration
regardless of how sequences come and go, and retired slots are backfilled.

Also the paper's end-to-end story at serve time: growing a small model
into the target architecture (Mango operator) and serving the grown
weights through the same engine -- and, because the engine talks only to
the family-agnostic slot-state protocol, the same loop serving a
RECURRENT family (griffin: O(1) rglru/conv state per slot + ring-buffer
local-attention caches).  The three models have head dims 16, 16 and 20:
on the card they run through the attention kernels' 64 bucket.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_continuous \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.launch.serve import build_params
from repro_torch.serve import ContinuousBatchingEngine, Request
from repro_torch.utils.device import resolve_device

# (arch, requests, max_len), as the reference example serves them
MODELS = (("qwen1.5-0.5b-smoke", 10, 64), ("gpt-micro-big", 6, 64),
          ("recurrentgemma-2b-smoke", 6, 40))
GROWN_FROM = {"gpt-micro-big": "gpt-micro"}


def mixed_trace(cfg, n, *, seed=0, max_prompt=24, max_gen=12):
    """``n`` requests of 4..max_prompt prompt and 2..max_gen new tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(4, max_prompt + 1))
        gen = int(rng.integers(2, max_gen + 1))
        prompt = lm_batch(cfg.vocab_size, 1, plen, seed=100 + uid)[0]
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=gen))
    return reqs


def model_params(name, device):
    """Seeded random weights, or for gpt-micro-big weights grown by Mango
    (rank 1, untrained operator) from a seeded gpt-micro."""
    cfg = get_config(name)
    return build_params(cfg, grow_from=GROWN_FROM.get(name),
                        grow_method="mango", grow_steps=0, device=device,
                        log_fn=lambda *a, **k: None)


def serve(name, params, n, max_len):
    """-> (engine, {uid: tokens}, seconds) of ``n`` mixed requests."""
    cfg = get_config(name)
    engine = ContinuousBatchingEngine(cfg, params, capacity=4,
                                      max_len=max_len)
    reqs = mixed_trace(cfg, n)
    t0 = time.perf_counter()
    out = engine.run(reqs)
    return engine, out, time.perf_counter() - t0


def main(argv=None, params=None):
    """Serves the three models; ``params`` ({arch: weights}) replaces the
    seeded ones.  -> {arch: {uid: tokens}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outs = {}
    for name, n, max_len in MODELS:
        p = (params or {}).get(name)
        if p is None:
            p = model_params(name, dev)
        engine, out, dt = serve(name, p, n, max_len)
        outs[name] = out
        n_tok = sum(len(v) for v in out.values())
        line = f"{name:24s} served {n} mixed-length requests ({n_tok} " \
            f"tokens) in {dt:.2f}s via {engine.n_decode_dispatches} " \
            f"macro-steps ({engine.n_host_syncs / max(n_tok, 1):.2f} host " \
            f"syncs/token)"
        if name in GROWN_FROM:
            line += f" on Mango-grown params from {GROWN_FROM[name]}"
        if engine.cache_layout != "full":
            ring = engine.pool["attn"]["k"].shape[2]
            line += f" ({engine.cache_layout} slots, attn ring={ring} of " \
                f"window={engine.cfg.window})"
        print(line)
        for uid in (0, 1):
            print(f"  req {uid}: {np.asarray(out[uid]).tolist()}")
    return outs


if __name__ == "__main__":
    with torch.no_grad():
        main()
