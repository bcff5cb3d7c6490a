"""Batched serving example: prefill a batch of prompts on a smoke-scale
config of each family (a RoPE transformer, griffin, xlstm) and greedy-
decode continuations with a cache, through the same ``prefill`` and
``decode_step`` the naive serving launcher runs.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.launch.serve import build_params, generate
from repro_torch.utils.device import resolve_device

ARCHS = ("qwen3-0.6b-smoke", "recurrentgemma-2b-smoke", "xlstm-1.3b-smoke")
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 24, 12  # as the reference example


def main(argv=None, params=None):
    """Generates for the three configs; ``params`` ({arch: weights})
    replaces the seeded ones.  -> {arch: (BATCH, NEW_TOKENS) numpy
    tokens}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outs = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        p = (params or {}).get(arch)
        if p is None:
            p = build_params(cfg, seed=0, device=dev)
        prompts = torch.from_numpy(lm_batch(cfg.vocab_size, BATCH,
                                            PROMPT_LEN)).to(dev)
        t0 = time.perf_counter()
        toks = generate(cfg, p, prompts,
                        max_new_tokens=NEW_TOKENS).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"{arch:28s} generated {toks.shape} in {dt:5.2f}s; "
              f"sample row: {np.asarray(toks[0])[:8]}")
        outs[arch] = toks
    return outs


if __name__ == "__main__":
    with torch.no_grad():
        main()
