"""The paper's own experiment models (Tables 4/5): DeiT, BERT, GPT.

DeiT variants are ViTs expressed through the transformer family
(``head="cls"``, stub patch embeddings as continuous inputs, learned
positions).  BERT is an encoder (non-causal); GPT is a causal pre-LN
decoder.  The micro variants keep the growth mappings at CPU scale.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register_named

_PATCH = 16 * 16 * 3  # patchified input dim


def _deit(name, layers, hidden, heads, **kw):
    base = dict(
        name=name, family="transformer", n_layers=layers, d_model=hidden,
        n_heads=heads, n_kv_heads=heads, d_ff=4 * hidden, vocab_size=1,
        causal=False, continuous_inputs=_PATCH, rope="none",
        learned_pos=197, head="cls", n_classes=1000, norm="ln", act="gelu",
        max_seq_len=256)
    base.update(kw)
    return ModelConfig(**base)


@register_named("deit-t-a")
def deit_t_a():
    return _deit("deit-t-a", 12, 192, 3)


@register_named("deit-t-b")
def deit_t_b():
    return _deit("deit-t-b", 10, 320, 5)


@register_named("deit-t-c")
def deit_t_c():
    return _deit("deit-t-c", 12, 384, 6)


@register_named("deit-s")
def deit_s():
    return _deit("deit-s", 12, 384, 6)


@register_named("deit-b")
def deit_b():
    return _deit("deit-b", 12, 768, 12)


def _bert(name, layers, hidden, heads):
    return ModelConfig(
        name=name, family="transformer", n_layers=layers, d_model=hidden,
        n_heads=heads, n_kv_heads=heads, d_ff=4 * hidden, vocab_size=30522,
        causal=False, rope="none", learned_pos=512, norm="ln", act="gelu",
        max_seq_len=512)


@register_named("bert-small")
def bert_small():
    return _bert("bert-small", 12, 512, 8)


@register_named("bert-base")
def bert_base():
    return _bert("bert-base", 12, 768, 12)


@register_named("bert-large")
def bert_large():
    return _bert("bert-large", 24, 1024, 16)


def _gpt(name, layers, hidden, heads):
    return ModelConfig(
        name=name, family="transformer", n_layers=layers, d_model=hidden,
        n_heads=heads, n_kv_heads=heads, d_ff=4 * hidden, vocab_size=50257,
        causal=True, rope="none", learned_pos=1024, norm="ln", act="gelu",
        max_seq_len=1024)


@register_named("gpt-small")
def gpt_small():
    return _gpt("gpt-small", 12, 512, 8)


@register_named("gpt-base")
def gpt_base():
    return _gpt("gpt-base", 12, 768, 12)


def _micro(base: ModelConfig, name, layers, hidden, heads, **kw):
    return base.replace(
        name=name, n_layers=layers, d_model=hidden, n_heads=heads,
        n_kv_heads=heads, d_ff=4 * hidden, **kw)


@register_named("gpt-micro")
def gpt_micro():
    return _micro(_gpt("x", 4, 64, 4), "gpt-micro", 4, 64, 4,
                  vocab_size=997, learned_pos=256, max_seq_len=256)


@register_named("gpt-micro-big")
def gpt_micro_big():
    return _micro(_gpt("x", 8, 128, 8), "gpt-micro-big", 8, 128, 8,
                  vocab_size=997, learned_pos=256, max_seq_len=256)


@register_named("deit-micro")
def deit_micro():
    return _deit("deit-micro", 3, 64, 4, n_classes=16).replace(
        learned_pos=65, continuous_inputs=48)


@register_named("deit-micro-big")
def deit_micro_big():
    return _deit("deit-micro-big", 6, 128, 8, n_classes=16).replace(
        learned_pos=65, continuous_inputs=48)
