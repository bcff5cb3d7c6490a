"""The ~100M end-to-end driver: train a 100M-parameter GPT for a few
hundred steps (optionally grown from a 25M model first).  Importing this
module registers ``gpt-100m`` and ``gpt-25m``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ModelConfig, register_named
from repro_torch.launch.train import train


@register_named("gpt-100m")
def gpt_100m():
    # 12L x 768 GPT-2-small-like on a 32k synthetic vocab: ~110M params
    return ModelConfig(
        name="gpt-100m", family="transformer", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32768,
        causal=True, rope="standard", norm="rms", act="swiglu",
        max_seq_len=1024)


@register_named("gpt-25m")
def gpt_25m():
    return gpt_100m().replace(name="gpt-25m", n_layers=6, d_model=384,
                              n_heads=6, n_kv_heads=6, d_ff=1536)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grow", action="store_true",
                    help="pretrain gpt-25m briefly and grow via Mango")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_100m")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without CUDA)")
    args = ap.parse_args(argv)
    common = dict(batch=args.batch, seq=args.seq, device=args.device)
    if args.grow:
        print("=== pretraining the 25M source ===")
        train("gpt-25m", steps=max(args.steps // 4, 20), log_every=10,
              **common)
        print("=== growing 25M -> 100M (Mango) + training ===")
        return train("gpt-100m", steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=max(args.steps // 3, 1), grow_from="gpt-25m",
                     grow_method="mango", grow_steps=20, log_every=10,
                     watchdog_s=600, **common)
    return train("gpt-100m", steps=args.steps, ckpt_dir=args.ckpt_dir,
                 ckpt_every=max(args.steps // 3, 1), log_every=10,
                 watchdog_s=600, **common)


if __name__ == "__main__":
    main()
