"""Llama-3 405B (arXiv:2407.21783; unverified) — 126L d_model=16384 128H
(GQA kv=8) d_ff=53248 vocab=128256."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="llama3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    rope_theta=500000.0,
)
