"""MusicGen-medium (arXiv:2306.05284; hf) — decoder-only transformer over
EnCodec tokens: 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB: the model consumes/produces EnCodec token
ids directly (``input_specs()`` provides the token stream).  Adaptation
note (DESIGN.md): sinusoidal positions → RoPE (substrate-uniform)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    norm="layernorm",
    act="gelu",
)
