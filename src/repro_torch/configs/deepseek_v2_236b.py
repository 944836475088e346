"""DeepSeek-V2 236B (arXiv:2405.04434; hf) — MoE with multi-head latent
attention.  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400;
MLA kv_lora=512 (rope 64 + nope 128, v 128, q_lora 1536);
2 shared + 160 routed experts, top-6, first layer dense (d_ff 12288)."""

from .base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,           # MLA: per-head latent decompression
    d_ff=12288,               # dense-FFN width (first_dense layers)
    vocab_size=102400,
    head_dim=192,             # nope 128 + rope 64 (q/k); v heads are 128
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536,
                  n_shared=2, d_shared=1536, first_dense=1,
                  router_scale=16.0, norm_topk_prob=False),
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                  v_dim=128),
)

SMOKE = ModelConfig(
    param_dtype="float32",
    compute_dtype="float32",
    name="deepseek-v2-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=48,              # nope 32 + rope 16
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  d_shared=32, first_dense=1, router_scale=4.0,
                  norm_topk_prob=False),
    mla=MLAConfig(q_lora=32, kv_lora=32, rope_dim=16, nope_dim=32, v_dim=32),
)
