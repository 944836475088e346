# LM substrate for the assigned architectures, on one device:
#   layers      - norms, RoPE, blockwise flash attention (and backward), MLPs
#   attn        - GQA attention with a KV / sliding-window ring cache
#   mla         - DeepSeek-V2 multi-head latent attention (+ absorbed decode)
#   moe         - top-k routed experts (capacity dispatch)
#   rglru       - RG-LRU recurrent block (doubling scan / O(1) decode)
#   ssd         - Mamba-2 state-space duality (chunked matmul form)
#   transformer - composable decoder over the per-layer block pattern
#   early_exit  - cascade early-exit decoding (the paper's technique on LMs)
from .transformer import Model, param_count, params_from_reference  # noqa: F401
