"""The ten reference architectures (the port's copy of
``repro.configs.archs``), each at its published widths with a reduced
``-smoke`` twin, plus yi-9b's Mango source ``yi-9b-half`` and the
CPU-sized ``griffin-micro`` pair.

The MoE decoders phi3.5-moe-42b [hf] and deepseek-v3-671b
[arXiv:2412.19437] (MLA, MoE and the MTP head); the RoPE dense decoders
stablelm-3b [hf, unverified], qwen1.5-0.5b [hf], qwen3-0.6b [hf] and
yi-9b [arXiv:2403.04652]; qwen2-vl-72b [arXiv:2409.12191] (multimodal
RoPE; the vision frontend is a stub in the reference too); the griffin
family's recurrentgemma-2b [arXiv:2402.19427]; the xlstm family's
xlstm-1.3b [arXiv:2405.04517, unverified]; and the hubert-xlarge encoder
[arXiv:2106.07447, unverified] (continuous inputs, non-causal).  The
reference's TPU-only ``remat`` knob is left out, as in ``configs/base.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register_named

_SCALE = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@register_named("phi3.5-moe-42b")
def phi35_moe():
    return ModelConfig(
        name="phi3.5-moe-42b", family="transformer",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064,
        moe=True, n_experts=16, top_k=2, expert_d_ff=6400,
        router_score="softmax", capacity_factor=1.25,
        act="swiglu", norm="rms", rope="standard", rope_theta=10000.0,
        max_seq_len=131072, **_SCALE)


@register_named("phi3.5-moe-42b-smoke")
def phi35_moe_smoke():
    return phi35_moe().replace(
        name="phi3.5-moe-42b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, expert_d_ff=128, n_experts=4,
        vocab_size=128, max_seq_len=256, param_dtype="float32",
        compute_dtype="float32", attn_chunk=16)


@register_named("deepseek-v3-671b")
def deepseek_v3():
    return ModelConfig(
        name="deepseek-v3-671b", family="transformer",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=18432, vocab_size=129280,
        mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128,
        moe=True, moe_layer_start=3, n_experts=256, top_k=8,
        n_shared_experts=1, expert_d_ff=2048, router_score="sigmoid",
        capacity_factor=1.25, aux_loss_weight=1e-4,
        mtp=True, act="swiglu", norm="rms", rope_theta=10000.0,
        max_seq_len=131072, **_SCALE)


@register_named("deepseek-v3-671b-smoke")
def deepseek_v3_smoke():
    return deepseek_v3().replace(
        name="deepseek-v3-671b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
        moe_layer_start=1, n_experts=4, top_k=2, expert_d_ff=64,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, max_seq_len=256, param_dtype="float32",
        compute_dtype="float32", attn_chunk=16)


@register_named("stablelm-3b")
def stablelm_3b():
    return ModelConfig(
        name="stablelm-3b", family="transformer",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=6912, vocab_size=50304,
        act="swiglu", norm="ln", rope="standard", rope_fraction=0.25,
        rope_theta=10000.0, max_seq_len=4096, **_SCALE)


@register_named("stablelm-3b-smoke")
def stablelm_3b_smoke():
    return stablelm_3b().replace(
        name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab_size=128,
        max_seq_len=256, param_dtype="float32", compute_dtype="float32",
        attn_chunk=16)


@register_named("qwen1.5-0.5b")
def qwen15_05b():
    return ModelConfig(
        name="qwen1.5-0.5b", family="transformer",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=2816, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        act="swiglu", norm="rms", rope="standard", rope_theta=1000000.0,
        max_seq_len=32768, **_SCALE)


@register_named("qwen1.5-0.5b-smoke")
def qwen15_05b_smoke():
    return qwen15_05b().replace(
        name="qwen1.5-0.5b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab_size=256,
        max_seq_len=256, param_dtype="float32", compute_dtype="float32",
        attn_chunk=16)


@register_named("qwen3-0.6b")
def qwen3_06b():
    return ModelConfig(
        name="qwen3-0.6b", family="transformer",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936, qk_norm=True, tie_embeddings=True,
        act="swiglu", norm="rms", rope="standard", rope_theta=1000000.0,
        max_seq_len=40960, **_SCALE)


@register_named("qwen3-0.6b-smoke")
def qwen3_06b_smoke():
    return qwen3_06b().replace(
        name="qwen3-0.6b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=160, vocab_size=256,
        max_seq_len=256, param_dtype="float32", compute_dtype="float32",
        attn_chunk=16)


@register_named("yi-9b")
def yi_9b():
    return ModelConfig(
        name="yi-9b", family="transformer",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab_size=64000,
        act="swiglu", norm="rms", rope="standard", rope_theta=5000000.0,
        max_seq_len=4096, **_SCALE)


@register_named("yi-9b-smoke")
def yi_9b_smoke():
    return yi_9b().replace(
        name="yi-9b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=256, max_seq_len=256,
        param_dtype="float32", compute_dtype="float32", attn_chunk=16)


@register_named("yi-9b-half")
def yi_9b_half():
    """yi-9b's Mango source: M(24, 2048) -> M(48, 4096), the paper's L/2,
    D/2 setting."""
    return yi_9b().replace(
        name="yi-9b-half", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=2, head_dim=128, d_ff=5504, vocab_size=64000)


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


@register_named("qwen2-vl-72b")
def qwen2_vl_72b():
    return ModelConfig(
        name="qwen2-vl-72b", family="transformer",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064, qkv_bias=True,
        act="swiglu", norm="rms", rope="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1000000.0, max_seq_len=32768, **_SCALE)


@register_named("qwen2-vl-72b-smoke")
def qwen2_vl_72b_smoke():
    return qwen2_vl_72b().replace(
        name="qwen2-vl-72b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=256,
        mrope_sections=(2, 3, 3), max_seq_len=256, param_dtype="float32",
        compute_dtype="float32", attn_chunk=16)


@register_named("xlstm-1.3b")
def xlstm_13b():
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304, proj_factor=2.0, slstm_every=8, conv_width=4,
        norm="ln", max_seq_len=1048576, **_SCALE)


@register_named("xlstm-1.3b-smoke")
def xlstm_13b_smoke():
    return xlstm_13b().replace(
        name="xlstm-1.3b-smoke", n_layers=4, d_model=64, n_heads=4,
        d_ff=0, vocab_size=256, slstm_every=4, max_seq_len=256,
        param_dtype="float32", compute_dtype="float32", attn_chunk=16)


@register_named("hubert-xlarge")
def hubert_xlarge():
    return ModelConfig(
        name="hubert-xlarge", family="transformer",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab_size=504, causal=False, continuous_inputs=1280,
        rope="none", learned_pos=32768, act="gelu", norm="ln",
        max_seq_len=32768, **_SCALE)


@register_named("hubert-xlarge-smoke")
def hubert_xlarge_smoke():
    return hubert_xlarge().replace(
        name="hubert-xlarge-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab_size=32,
        continuous_inputs=64, learned_pos=256, max_seq_len=256,
        param_dtype="float32", compute_dtype="float32", attn_chunk=16)


ARCH_IDS = [
    "phi3.5-moe-42b", "deepseek-v3-671b", "stablelm-3b", "qwen1.5-0.5b",
    "qwen3-0.6b", "yi-9b", "recurrentgemma-2b", "qwen2-vl-72b",
    "xlstm-1.3b", "hubert-xlarge",
]
