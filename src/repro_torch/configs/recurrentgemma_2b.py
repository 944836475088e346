"""RecurrentGemma-2B (arXiv:2402.19427; hf) — hybrid Griffin: RG-LRU
recurrent blocks + local attention, pattern (R, R, A).  26L d_model=2560
10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.  Sub-quadratic →
runs long_500k."""

from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(width=2560, conv_width=4, window=2048,
                      pattern=("rglru", "rglru", "attn")),
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=3,                # one full (R, R, A) pattern
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    act="gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(width=64, conv_width=4, window=32,
                      pattern=("rglru", "rglru", "attn")),
)
