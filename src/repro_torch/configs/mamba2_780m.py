"""Mamba2-780M (arXiv:2405.21060; unverified) — SSD (state-space duality),
attention-free: 48L d_model=1536 vocab=50280, ssm_state=128, expand=2,
head_dim=64 (→ 48 SSD heads of the 3072-wide inner stream).
Sub-quadratic → runs long_500k."""

from .base import ModelConfig, SSDConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,               # d_inner / head_dim = 3072 / 64
    n_kv_heads=48,
    d_ff=0,                   # attn-free, no separate FFN (SSD block only)
    vocab_size=50280,
    tie_embeddings=True,
    ssd=SSDConfig(d_state=128, head_dim=64, expand=2, chunk=256,
                  conv_width=4, n_groups=1),
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,                # d_inner 128 / head_dim 32
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    tie_embeddings=True,
    ssd=SSDConfig(d_state=16, head_dim=32, expand=2, chunk=16,
                  conv_width=4, n_groups=1),
)
