"""Qwen3-MoE 235B-A22B (hf:Qwen/Qwen3-30B-A3B family) — 94L d_model=4096
64H (GQA kv=4) expert d_ff=1536 vocab=151936; 128 routed experts top-8,
no shared experts, normalized top-k."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                # kept for reference; every layer is MoE
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                  n_shared=0, norm_topk_prob=True),
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, norm_topk_prob=True),
)
