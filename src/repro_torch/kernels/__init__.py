# The port's kernels: hand-written CUDA C++ for sm_90a under ../csrc, built
# and bound by native.py, each with its plain PyTorch version beside it.
#   integral_image  - kernel S, the SAT phase (three padded SATs)
#   fused_head      - kernel A, the fused dense head's tile pass
#   haar_stage      - kernel B, one stage's dense sums (split head)
#   packed_window   - kernel C, stage-run sums over a packed window list
#   window_variance - kernel D, the 1/sigma grids
#   tail_gates      - kernel E, a tail segment's stage gates and per-image
#                     survivor counts
#   tile_change     - the stream's tile planning (plain PyTorch; jnp in the
#                     reference, no kernel)
# ops.py = the public wrappers (+ *_ref twins over ref.py); packed_tail.py
# = the compacted-tail evaluator (gather / bulk / pallas backends).
from . import ops, packed_tail, ref  # noqa: F401
