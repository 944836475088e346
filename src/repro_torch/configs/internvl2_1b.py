"""InternVL2-1B (arXiv:2404.16821; hf) — InternViT-300M frontend (STUB:
``input_specs()`` provides precomputed patch embeddings) + Qwen2-0.5B LM
backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1000000.0,
    n_prefix_embeds=256,          # ViT patch tokens per image (stubbed)
    input_mode="tokens+prefix",
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    n_prefix_embeds=8,
    input_mode="tokens+prefix",
)
