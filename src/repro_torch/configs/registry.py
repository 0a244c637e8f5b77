"""--arch registry: the ten assigned architectures + the paper's own workload."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# LM-family transformers (assigned pool; [source; tier] in `source`)
# ---------------------------------------------------------------------------

MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, moe_d_ff=16384, window=4096, rope_theta=1e6,
    router_norm="topk_softmax", source="[arXiv:2401.04088; hf] 8e top-2, SWA",
)

DEEPSEEK_V2_236B = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=12288, vocab_size=102400,
    attn_type="mla", q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536, first_dense_layers=1,
    router_norm="softmax_topk", source="[arXiv:2405.04434; hf] MLA kv_lora=512, 2 shared+160 routed top-6",
)

WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, encoder_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
    act="gelu", frontend="audio_frames", n_frontend_tokens=1500, tie_embeddings=True,
    source="[arXiv:2212.04356; unverified] enc-dec, conv frontend (stub)",
)

LLAMA3_405B = ModelConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, head_dim=128, d_ff=53248, vocab_size=128256, rope_theta=5e5,
    source="[arXiv:2407.21783; unverified] GQA 128k vocab",
)

GEMMA2_2B = ModelConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304, n_heads=8,
    n_kv_heads=4, head_dim=256, d_ff=9216, vocab_size=256000,
    local_global=True, window=4096, attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True, source="[arXiv:2408.00118; hf] local+global alternating, logit softcap",
)

QWEN3_1_7B = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, head_dim=128, d_ff=6144, vocab_size=151936, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True, source="[hf:Qwen/Qwen3-8B; hf] qk_norm, GQA",
)

GRANITE_8B = ModelConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=49152,
    source="[arXiv:2405.04324; hf] llama-arch, code",
)

MAMBA2_780M = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, tie_embeddings=True,
    source="[arXiv:2405.21060; unverified] SSD (state-space duality)",
)

ZAMBA2_7B = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, head_dim=112, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, attn_every=6,
    source="[arXiv:2411.15242; unverified] Mamba2 + shared attn blocks",
)

INTERNVL2_1B = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151655,
    frontend="vision_patches", n_frontend_tokens=256, tie_embeddings=True,
    rope_theta=1e6, source="[arXiv:2404.16821; hf] InternViT + InternLM2 (patch stub)",
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        MIXTRAL_8X22B, DEEPSEEK_V2_236B, WHISPER_SMALL, LLAMA3_405B, GEMMA2_2B,
        QWEN3_1_7B, GRANITE_8B, MAMBA2_780M, ZAMBA2_7B, INTERNVL2_1B,
    )
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
