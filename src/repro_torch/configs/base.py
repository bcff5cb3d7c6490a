"""Config dataclass + registry (the port's own copy of ``repro.configs``).

One flat dataclass covers every family: configs are data, ``family``
selects the forward implementation, and fields a family does not use are
ignored.  The TPU-only knobs of the reference (``decode_kernel``,
``remat``, ``attn_logits_dtype``, ``attn_prefix_chunks``,
``unroll_scans``) are left out: the port has one attention route per call
site and the tensor's device picks kernel or plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "transformer"  # transformer | griffin | xlstm | vit
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 256

    act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rms"  # rms | ln
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    scale_embeddings: bool = False

    rope: str = "standard"  # none | standard | mrope
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    learned_pos: int = 0  # >0: learned absolute positions (max len)
    tie_embeddings: bool = False
    continuous_inputs: int = 0  # >0: stub frontend input dim (audio/vision)
    head: str = "lm"  # lm | cls | none

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    router_score: str = "softmax"  # softmax | sigmoid
    capacity_factor: float = 1.25
    moe_dispatch_dtype: str = "float32"
    moe_layer_start: int = 0
    aux_loss_weight: float = 0.01

    # --- MLA (DeepSeek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False
    mtp_weight: float = 0.3

    # --- local attention ---
    window: Optional[int] = None

    # --- griffin / recurrent ---
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    conv_width: int = 4

    # --- xlstm ---
    proj_factor: float = 2.0
    slstm_every: int = 0

    # --- vit ---
    image_size: int = 224
    patch_size: int = 16
    n_classes: int = 1000

    # --- runtime policy ---
    max_seq_len: int = 8192
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 512

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_dense_layers(self):
        return self.moe_layer_start if self.moe else self.n_layers

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


_REGISTRY: dict = {}


def register_named(name):
    """Decorator registering a zero-arg config factory under ``name``."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.archs  # noqa: F401  (populate the registry)
    import repro_torch.configs.paper_models  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown config '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    import repro_torch.configs.archs  # noqa: F401
    import repro_torch.configs.paper_models  # noqa: F401
    return sorted(_REGISTRY)
