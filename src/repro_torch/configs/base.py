"""Model / shape config dataclasses shared by every assigned architecture.

One ``ModelConfig`` describes any of the five families (dense / moe /
hybrid / ssm / vlm / audio) via a per-layer *block pattern*; family-
specific sub-configs (MoE, MLA, RG-LRU, SSD) are attached when used.
All fields are static hashables so configs can key jit caches.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "RGLRUConfig",
           "SSDConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                  # routed experts
    top_k: int
    d_expert: int                   # per-expert FFN width
    n_shared: int = 0               # shared (always-on) experts
    d_shared: int = 0               # shared-expert FFN width (0 = d_expert)
    capacity_factor: float = 1.25
    router_scale: float = 1.0       # routed_scaling_factor (deepseek)
    norm_topk_prob: bool = True     # renormalize top-k probs
    first_dense: int = 0            # leading layers with dense FFN (deepseek=1)
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int                     # query low-rank dim (0 = full-rank q)
    kv_lora: int                    # latent kv dim (the compressed cache)
    rope_dim: int                   # decoupled rope dims per head
    nope_dim: int                   # non-rope dims per head
    v_dim: int                      # value head dim


@dataclass(frozen=True)
class RGLRUConfig:
    width: int                      # recurrence width (= d_model here)
    conv_width: int = 4
    window: int = 2048              # local-attention window
    pattern: tuple = ("rglru", "rglru", "attn")   # repeating block pattern
    c: float = 8.0                  # RG-LRU exponent constant


@dataclass(frozen=True)
class SSDConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 = d_model // n_heads
    norm: str = "rmsnorm"           # rmsnorm | layernorm | layernorm_np
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_frac: float = 1.0          # fraction of head dims rotated
    tie_embeddings: bool = False
    act: str = "silu"               # FFN activation (silu→SwiGLU, gelu→GeGLU)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ssd: Optional[SSDConfig] = None
    # modality frontend stubs (vlm / audio): extra embedding inputs
    n_prefix_embeds: int = 0        # patch/frame embeddings prepended
    input_mode: str = "tokens"      # tokens | embeddings | tokens+prefix
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    # attention implementation
    attn_chunk_q: int = 512         # flash q-block
    attn_chunk_kv: int = 1024       # flash kv-block
    # distribution defaults (overridable at launch)
    remat: str = "block"            # none | block | full
    scan_layers: bool = True

    # ------------------------------------------------------------ derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def block_pattern(self) -> tuple:
        """Per-layer block kinds, length n_layers."""
        if self.family == "ssm":
            return ("ssd",) * self.n_layers
        if self.rglru is not None:
            pat = self.rglru.pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can run long_500k (no full-attention layer)."""
        return all(k in ("ssd", "rglru") or
                   (k == "attn" and self.rglru is not None)
                   for k in self.block_pattern) and (
            self.family in ("ssm", "hybrid"))

    def n_params(self) -> int:
        """Total parameter count (exact, from the shape inventory)."""
        from repro_torch.models.transformer import param_count
        return param_count(self)

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        from repro_torch.models.transformer import param_count
        return param_count(self, active_only=True)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
