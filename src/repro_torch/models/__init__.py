# LM substrate for the assigned architectures, on one device or a mesh:
#   layers      - norms, RoPE, blockwise flash attention (and backward), MLPs
#   attn        - GQA attention with a KV / sliding-window ring cache (and
#                 its mesh layout: head-sharded flash, sequence-split decode)
#   mla         - DeepSeek-V2 multi-head latent attention (+ absorbed decode)
#   moe         - top-k routed experts (capacity dispatch; expert parallel
#                 under shard_map)
#   rglru       - RG-LRU recurrent block (doubling scan / O(1) decode)
#   ssd         - Mamba-2 state-space duality (chunked matmul form)
#   transformer - composable decoder over the per-layer block pattern
#   early_exit  - cascade early-exit decoding (the paper's technique on LMs)
from .transformer import (Model, build_model, param_count,  # noqa: F401
                          params_from_reference)
