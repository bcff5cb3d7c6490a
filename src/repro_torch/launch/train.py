"""Trainer: training loop, optionally from a model grown by the paper's
operator, with checkpoints, resume and growth from a checkpointed source.
Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-base \
      --grow-from gpt-small --grow-steps 10 --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-micro-big \
      --grow-from gpt-micro --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-micro \
      --device cpu --steps 20 --ckpt-dir ckpt/gpt-micro --ckpt-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-micro \
      --device cpu --steps 40 --ckpt-dir ckpt/gpt-micro --resume

Checkpoints are in the reference package's on-disk format
(``repro_torch.checkpoint``), so either package resumes what the other
wrote.  With ``grow_from``, the source's weights come from
``grow_src_ckpt``, or else from the sibling directory
``<ckpt_dir>/../<grow_from>`` when it exists (whether or not ``ckpt_dir``
does yet).  One device: the
reference's mesh and sharding have nothing to do here.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import lm_data_iter, vision_batch
from repro_torch.models import get_family
from repro_torch.optim import (
    OptimizerConfig,
    linear_warmup_cosine,
    make_optimizer,
)
from repro_torch.train.steps import make_train_step
from repro_torch.utils.device import resolve_device


def data_for(cfg, batch, seq, seed=0, start_step=0):
    """Synthetic batches (numpy) from ``start_step`` on: vision batches for
    a ``cls`` head, token chains for an LM."""
    if cfg.head == "cls":
        def it():
            step = start_step
            while True:
                b = vision_batch(cfg.n_classes, batch, cfg.image_size,
                                 cfg.patch_size, seed=seed, step=step)
                # the stub frontend's dims must match continuous_inputs
                b["inputs"] = b["inputs"][..., :cfg.continuous_inputs]
                b["inputs"] = b["inputs"][:, :cfg.learned_pos - 1]
                yield b
                step += 1
        return it()
    return lm_data_iter(cfg.vocab_size, batch, seq, seed=seed,
                        start_step=start_step)


def _source_params(cfg_src, src_ckpt, seed, dev, log_fn):
    """The growth source: its checkpoint's ``p`` when ``src_ckpt`` is a
    directory, else None (``grow_from_source`` then draws a fresh one)."""
    if not (src_ckpt and os.path.isdir(src_ckpt)):
        return None
    from repro_torch.checkpoint import load_checkpoint

    gen = torch.Generator(device=dev).manual_seed(seed)
    template = get_family(cfg_src).init(gen, cfg_src)
    tree, sstep, _ = load_checkpoint(src_ckpt, {"p": template, "o": None})
    log_fn(f"[grow] source weights from {src_ckpt} @ step {sstep}")
    return tree["p"]


def train(arch: str, *, steps=100, batch=8, seq=None, lr=3e-4, warmup=20,
          ckpt_dir=None, ckpt_every=0, resume=False, grow_from=None,
          grow_method="mango", grow_rank=1, grow_steps=50,
          grow_src_ckpt=None, log_every=10, seed=0, watchdog_s=None,
          n_microbatches=1, device="cuda", log_fn=print):
    """-> (params, history): train ``arch`` up to step ``steps`` from a
    fresh init, grown from ``grow_from``, or resumed from the newest
    checkpoint in ``ckpt_dir``; history holds the logged metrics."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    fam = get_family(cfg)
    seq = seq or min(cfg.max_seq_len, 256)

    opt_cfg = OptimizerConfig(lr=lr, weight_decay=1e-2)
    schedule = linear_warmup_cosine(lr, warmup, steps)
    init_fn, _ = make_optimizer(opt_cfg, schedule)
    step_fn = make_train_step(cfg, opt_cfg, schedule,
                              n_microbatches=n_microbatches)

    # ---- init (fresh, grown from a source model, or resumed) ----
    start = 0
    if grow_from:
        from repro_torch.core import grow as growlib

        cfg_src = get_config(grow_from)
        # resolved lexically: the reference stats "<ckpt_dir>/..", which
        # finds the sibling only once ckpt_dir exists (ROADMAP.md §3)
        src_ckpt = grow_src_ckpt or (
            ckpt_dir and os.path.normpath(
                os.path.join(ckpt_dir, "..", grow_from)))
        params = growlib.grow_from_source(
            cfg_src, cfg, method=grow_method, rank=grow_rank,
            steps=grow_steps, data_iter=data_for(cfg, batch, seq, seed + 1),
            params_src=_source_params(cfg_src, src_ckpt, seed, dev, log_fn),
            seed=seed, device=dev, log_fn=log_fn)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = fam.init(gen, cfg)
    opt_state = init_fn(params)

    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3,
                                every=ckpt_every or max(steps // 4, 1),
                                async_save=True)
        if resume:
            restored = mgr.restore_latest({"p": params, "o": opt_state})
            if restored:
                tree, start, _ = restored
                params, opt_state = tree["p"], tree["o"]
                log_fn(f"[resume] restored step {start}")

    history = []
    data = data_for(cfg, batch, seq, seed, start_step=start)
    t0 = t_last = time.perf_counter()
    for step in range(start, steps):
        b = {k: torch.as_tensor(v).to(dev) for k, v in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b, step + 1)
        if watchdog_s and time.perf_counter() - t_last > watchdog_s:
            log_fn(f"[watchdog] step {step} exceeded {watchdog_s}s")
        t_last = time.perf_counter()
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log_fn(f"step {step:5d}  loss {m.get('loss', 0):.4f}  "
                   f"gnorm {m.get('grad_norm', 0):.3f}  "
                   f"({time.perf_counter() - t0:.1f} s)")
        if mgr:
            mgr.maybe_save(step + 1, {"p": params, "o": opt_state},
                           extra={"arch": arch})
    if mgr:
        mgr.maybe_save(steps, {"p": params, "o": opt_state},
                       extra={"arch": arch}, force=True)
        mgr.wait()
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
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
        lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, grow_from=args.grow_from,
        grow_method=args.grow_method, grow_rank=args.grow_rank,
        grow_steps=args.grow_steps, n_microbatches=args.microbatches,
        device=args.device)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(hist, f, indent=1)


if __name__ == "__main__":
    main()
