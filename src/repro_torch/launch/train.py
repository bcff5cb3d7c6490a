"""Trainer: training loop, optionally from a model grown by the paper's
operator.  Runs on CUDA unless ``--device cpu`` is given, and raises when
CUDA is asked for and absent:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-base \
      --grow-from gpt-small --grow-steps 10 --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-micro-big \
      --grow-from gpt-micro --device cpu --steps 20

One device: the reference's mesh and sharding have nothing to do here.
Checkpointing (``--ckpt-dir``, ``--ckpt-every``, ``--resume``) is not
ported yet and exits with a named error.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_data_iter
from repro_torch.models import get_family
from repro_torch.optim import (
    OptimizerConfig,
    linear_warmup_cosine,
    make_optimizer,
)
from repro_torch.train.steps import make_train_step
from repro_torch.utils.device import resolve_device

# reference-package flags this slice does not port yet: name -> what it is
UNPORTED_FLAGS = {
    "--ckpt-dir": "checkpointing", "--ckpt-every": "checkpointing",
    "--resume": "checkpointing",
}


def data_for(cfg, batch, seq, seed=0):
    """Synthetic token batches (numpy) for an LM config."""
    if cfg.head == "cls":
        raise NotImplementedError(
            f"{cfg.name}: vision batches (the DeiT configs) are not ported "
            "to repro_torch yet (see ROADMAP.md)")
    return lm_data_iter(cfg.vocab_size, batch, seq, seed=seed)


def train(arch: str, *, steps=100, batch=8, seq=None, lr=3e-4, warmup=20,
          grow_from=None, grow_method="mango", grow_rank=1, grow_steps=50,
          log_every=10, seed=0, n_microbatches=1, device="cuda",
          log_fn=print):
    """-> (params, history): ``steps`` train steps of ``arch`` from a fresh
    init or grown from ``grow_from``; history holds the logged metrics."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    fam = get_family(cfg)
    seq = seq or min(cfg.max_seq_len, 256)

    opt_cfg = OptimizerConfig(lr=lr, weight_decay=1e-2)
    schedule = linear_warmup_cosine(lr, warmup, steps)
    init_fn, _ = make_optimizer(opt_cfg, schedule)
    step_fn = make_train_step(cfg, opt_cfg, schedule,
                              n_microbatches=n_microbatches)

    if grow_from:
        from repro_torch.core import grow as growlib

        params = growlib.grow_from_source(
            get_config(grow_from), cfg, method=grow_method, rank=grow_rank,
            steps=grow_steps, data_iter=data_for(cfg, batch, seq, seed + 1),
            seed=seed, device=dev, log_fn=log_fn)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = fam.init(gen, cfg)
    opt_state = init_fn(params)

    history = []
    data = data_for(cfg, batch, seq, seed)
    t0 = time.perf_counter()
    for step in range(steps):
        b = {k: torch.as_tensor(v).to(dev) for k, v in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b, step + 1)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log_fn(f"step {step:5d}  loss {m.get('loss', 0):.4f}  "
                   f"gnorm {m.get('grad_norm', 0):.3f}  "
                   f"({time.perf_counter() - t0:.1f} s)")
    return params, history


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            raise SystemExit(f"error: {flag} ({UNPORTED_FLAGS[flag]}) is not "
                             "ported to repro_torch yet (see ROADMAP.md)")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grow-from", default=None)
    ap.add_argument("--grow-method", default="mango",
                    choices=["mango", "ligo", "bert2bert", "stackbert",
                             "net2net"])
    ap.add_argument("--grow-rank", type=int, default=1)
    ap.add_argument("--grow-steps", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)
    _, hist = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, grow_from=args.grow_from, grow_method=args.grow_method,
        grow_rank=args.grow_rank, grow_steps=args.grow_steps,
        n_microbatches=args.microbatches, device=args.device)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(hist, f, indent=1)


if __name__ == "__main__":
    main()
