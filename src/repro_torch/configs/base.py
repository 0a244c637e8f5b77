"""Config system: model architecture + input shapes (the JAX package's
``configs/base.py``, field for field, so one config means the same model in
both packages).

Every assigned architecture is a ``ModelConfig`` in ``configs/registry.py``,
which maps ``--arch`` ids to them.  ``reduced()`` yields the same-family
tiny config used by the CPU parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # defaults to d_model // n_heads
    # --- attention features
    rope_theta: float = 1e4
    qk_norm: bool = False
    window: int | None = None            # sliding window (all attn layers)
    local_global: bool = False           # gemma2 alternating local/global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_type: str = "gqa"               # gqa | mla
    # --- MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_norm: str = "topk_softmax"    # mixtral | deepseek ("softmax_topk")
    # --- SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    attn_every: int = 0                  # zamba2: shared attn block period
    # --- encoder-decoder / multimodal frontend stubs
    encoder_layers: int = 0
    frontend: str | None = None          # audio_frames | vision_patches
    n_frontend_tokens: int = 0
    # --- misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                    # silu (swiglu) | gelu
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    source: str = ""                     # provenance note [arXiv; tier]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """May run long_500k: SSM / hybrid / windowed-attention archs."""
        return self.family in ("ssm", "hybrid") or self.window is not None or self.local_global

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder (whisper is enc-dec)

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        small: dict[str, Any] = dict(
            n_layers=min(self.n_layers, 4 if not self.attn_every else 5),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            dtype="float32",
            name=self.name + "-reduced",
        )
        if self.n_experts:
            small.update(n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2), moe_d_ff=64,
                         n_shared_experts=min(self.n_shared_experts, 1),
                         first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8, ssm_expand=2)
        if self.attn_every:
            small.update(attn_every=2)
        if self.q_lora_rank or self.kv_lora_rank:
            small.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                         v_head_dim=16, head_dim=None)
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.n_frontend_tokens:
            small.update(n_frontend_tokens=8)
        if self.window:
            small.update(window=16)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input-shape cells."""

    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch — long_500k skipped (see DESIGN.md)"
    return True, ""
