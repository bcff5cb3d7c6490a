"""End-to-end pipeline: pretrain -> checkpoint -> grow (Mango) from that
checkpoint -> continue training -> simulated failure -> resume.

This drives the same trainer the launcher exposes
(``repro_torch.launch.train``) and its checkpoint/restart path.  The step
counts default to the reference example's (100, 60 and 90, with 20
operator steps).

Run:  PYTHONPATH=src python -m repro_torch.examples.grow_pipeline \\
          [--device cpu] [--root DIR]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from repro_torch.launch.train import train


def run(root=None, *, pretrain_steps=100, grow_train_steps=60,
        resume_steps=90, grow_steps=20, device="cuda", log_fn=print):
    """The three stages under ``root`` (a temporary directory, removed at
    the end, when None); -> the history of stage 3."""
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="repro_pipeline_")
    small_dir = os.path.join(root, "gpt-micro")
    big_dir = os.path.join(root, "gpt-micro-big")

    log_fn("=== stage 1: pretrain the small model (with checkpoints) ===")
    train("gpt-micro", steps=pretrain_steps, batch=8, ckpt_dir=small_dir,
          ckpt_every=max(pretrain_steps // 2, 1), log_every=25,
          device=device, log_fn=log_fn)

    log_fn("\n=== stage 2: grow to the target + train, checkpointing ===")
    # the source comes from stage 1's checkpoint, big_dir's sibling
    train("gpt-micro-big", steps=grow_train_steps, batch=8, ckpt_dir=big_dir,
          ckpt_every=max(grow_train_steps // 3, 1), grow_from="gpt-micro",
          grow_method="mango", grow_steps=grow_steps, log_every=20,
          device=device, log_fn=log_fn)

    log_fn("\n=== stage 3: 'crash' mid-run and resume ===")
    # resume from the latest checkpoint and train further
    _, hist = train("gpt-micro-big", steps=resume_steps, batch=8,
                    ckpt_dir=big_dir, ckpt_every=max(resume_steps // 3, 1),
                    resume=True, log_every=15, device=device, log_fn=log_fn)
    log_fn(f"\npipeline complete; final loss {hist[-1]['loss']:.4f}; "
           f"artifacts in {root}")
    if own_root:
        shutil.rmtree(root, ignore_errors=True)
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="directory for the checkpoints (default: a "
                    "temporary one, removed at the end)")
    ap.add_argument("--pretrain-steps", type=int, default=100)
    ap.add_argument("--grow-train-steps", type=int, default=60)
    ap.add_argument("--resume-steps", type=int, default=90)
    ap.add_argument("--grow-steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)
    return run(args.root, pretrain_steps=args.pretrain_steps,
               grow_train_steps=args.grow_train_steps,
               resume_steps=args.resume_steps, grow_steps=args.grow_steps,
               device=args.device)


if __name__ == "__main__":
    main()
