"""Architecture configs beyond the paper's own models (the port's copy of
``repro.configs.archs``), added slice by slice.

So far the griffin family: recurrentgemma-2b [arXiv:2402.19427] at its
published widths, its reduced ``-smoke`` twin, and the CPU-sized
``griffin-micro`` pair.  The reference's TPU-only ``remat`` knob is left
out, as in ``configs/base.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register_named

_SCALE = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@register_named("recurrentgemma-2b")
def recurrentgemma_2b():
    return ModelConfig(
        name="recurrentgemma-2b", family="griffin",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000, lru_width=2560, conv_width=4,
        window=2048, act="geglu", norm="rms", rope_theta=10000.0,
        scale_embeddings=True, tie_embeddings=True,
        max_seq_len=1048576, **_SCALE)


@register_named("recurrentgemma-2b-smoke")
def recurrentgemma_2b_smoke():
    return recurrentgemma_2b().replace(
        name="recurrentgemma-2b-smoke", n_layers=5, d_model=80, n_heads=4,
        n_kv_heads=1, head_dim=20, d_ff=240, vocab_size=256, lru_width=80,
        window=32, max_seq_len=256, param_dtype="float32",
        compute_dtype="float32", attn_chunk=16)


@register_named("griffin-micro")
def griffin_micro():
    """Micro griffin (rec, rec, attn): its window (16) is far below
    max_seq_len, so serve-time local-attention rings wrap."""
    return ModelConfig(
        name="griffin-micro", family="griffin", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=192, vocab_size=257,
        lru_width=64, conv_width=4, window=16, act="geglu", norm="rms",
        rope_theta=10000.0, scale_embeddings=True, tie_embeddings=True,
        max_seq_len=256, attn_chunk=16)


@register_named("griffin-micro-big")
def griffin_micro_big():
    """griffin-micro at 2x layers and 2x width (same vocab and window)."""
    return griffin_micro().replace(
        name="griffin-micro-big", n_layers=6, d_model=128, n_heads=4,
        head_dim=32, d_ff=384, lru_width=128)
