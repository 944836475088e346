"""OLMo-1B (arXiv:2402.00838; hf) — 16L d_model=2048 16H (MHA kv=16)
d_ff=8192 vocab=50304, non-parametric LayerNorm, tied embeddings."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_np",       # OLMo: LN without scale/bias
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    norm="layernorm_np",
    tie_embeddings=True,
)
