"""Quickstart: grow a pretrained micro-GPT into a 2x bigger one with Mango
and watch the grown model start far below the scratch loss.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import grow as growlib
from repro_torch.data import lm_data_iter
from repro_torch.models import get_family
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loss import loss_for
from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.utils.device import resolve_device

BATCH, SEQ = 8, 64


def _on(dev, batch):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def pretrain(cfg, steps, seed=0, device="cuda"):
    dev = resolve_device(device)
    fam = get_family(cfg)
    params = fam.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_cfg = OptimizerConfig(lr=1e-3)
    init_fn, _ = make_optimizer(opt_cfg)
    opt = init_fn(params)
    step = make_train_step(cfg, opt_cfg)
    data = lm_data_iter(cfg.vocab_size, BATCH, SEQ, seed=seed)
    for s in range(steps):
        params, opt, m = step(params, opt, _on(dev, next(data)), s + 1)
        if s % 25 == 0:
            print(f"  [small] step {s:4d} loss {float(m['loss']):.4f}")
    return params


def main(argv=None):
    """-> {"grown": loss, "scratch": loss} of gpt-micro-big on a held-out
    batch; raises if the grown model does not start below scratch."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg_s = get_config("gpt-micro")
    cfg_t = get_config("gpt-micro-big")
    fam = get_family(cfg_t)
    print(f"pretraining {cfg_s.name} ...")
    small = pretrain(cfg_s, 120, device=dev)

    print("training Mango operator (Eq. 7, a few steps) ...")
    gop, op_params = growlib.build("mango", cfg_s, cfg_t, rank=1, device=dev)
    lf = loss_for(cfg_t)

    def op_loss(big, b):
        logits, aux = fam.forward(big, b, cfg_t)
        return lf(logits, aux, b, cfg_t)[0]

    data = lm_data_iter(cfg_t.vocab_size, BATCH, SEQ, seed=3)
    op_params, losses = growlib.train_operator(
        gop, op_params, small, op_loss, data, steps=25, lr=2e-3)
    print(f"  operator loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    with torch.no_grad():
        big = growlib.grow_params(gop, op_params, small)
    scratch = fam.init(torch.Generator(device=dev).manual_seed(99), cfg_t)
    ev = make_eval_step(cfg_t)
    b = _on(dev, next(lm_data_iter(cfg_t.vocab_size, BATCH, SEQ, seed=50)))
    l_grown = float(ev(big, b)["loss"])
    l_scratch = float(ev(scratch, b)["loss"])
    print(f"\ninitial loss of {cfg_t.name}: grown(Mango)={l_grown:.4f}  "
          f"scratch={l_scratch:.4f}")
    if not l_grown < l_scratch:
        raise AssertionError("growth should beat random init")
    print("OK: the grown model inherits the small model's knowledge.")
    return {"grown": l_grown, "scratch": l_scratch}


if __name__ == "__main__":
    main()
