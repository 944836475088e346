"""Kernel E: a tail segment's stage gates and per-image survivor counts.

``gate_counts(ss_run, thr, valid, b_sel, n_live, counts)`` takes a
segment's (k, cap) stage sums (kernel C's, or any tail backend's), the
segment's (k,) float32 thresholds, the (cap,) bool mask of lanes still
alive, each lane's int64 image index and the compaction's live count
(a 0-dim int64 tensor on the lanes' device).
It clears ``valid`` where a stage's sum falls below its threshold, stage
by stage, and adds to each row ``j`` of the int32 (k, B) ``counts`` the
number of each image's lanes still valid after stage ``j``.  Both are
updated in place; it returns ``valid``.

Lanes at or past ``min(n_live, cap)`` must be invalid on entry, as a
static-capacity compaction leaves them: the kernel neither reads nor
writes them, and the plain version's gates keep them invalid, so both
count nothing there.

On a CUDA tensor it launches ``csrc/tail_gates.cu`` once per 32 stages
(once per segment on the batched tail); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.tail_gate_counts_ref`, the per-stage gate
and ``index_add_`` it replaces.  The counts are integers, so both give the
same bits whatever the order of ``b_sel``.
"""

from __future__ import annotations

import torch

from . import native, ref
from .native import I32, I64, P, ptr, stream_of

__all__ = ["gate_counts", "MAX_STAGES", "KERNEL"]

MAX_STAGES = 32     # stages one launch gates

KERNEL = native.Kernel("tail_gates.cu", "tail_gate_counts",
                       [P, I64, P, I32, P, P, P, P, I32, I32, P])


def gate_counts(ss_run: torch.Tensor, thr: torch.Tensor, valid: torch.Tensor,
                b_sel: torch.Tensor, n_live: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """Gate ``valid`` by the k stages of ``ss_run`` and add each image's
    survivors after each stage to ``counts`` (both in place); returns
    ``valid``."""
    if ss_run.device.type == "cpu":
        return ref.tail_gate_counts_ref(ss_run, thr, valid, b_sel, n_live,
                                        counts)
    native.check_cuda(ss_run, torch.float32, 2, "ss_run")
    native.check_cuda(thr, torch.float32, 1, "thr")
    native.check_cuda(valid, torch.bool, 1, "valid")
    native.check_cuda(b_sel, torch.int64, 1, "b_sel")
    native.check_cuda(counts, torch.int32, 2, "counts")
    native.check_cuda(n_live, torch.int64, 0, "n_live")
    if any(t.device != ss_run.device
           for t in (thr, valid, b_sel, n_live, counts)):
        raise ValueError("kernel E's tensors must share one device")
    k, cap = ss_run.shape
    if thr.shape[0] != k or counts.shape[0] != k:
        raise ValueError(f"thr and counts need {k} stages, got "
                         f"{thr.shape[0]} and {counts.shape[0]}")
    if valid.shape[0] != cap or b_sel.shape[0] != cap:
        raise ValueError("ss_run, valid and b_sel differ in length")
    n_img = counts.shape[1]
    if cap == 0 or k == 0 or n_img == 0:
        return valid
    for j0 in range(0, k, MAX_STAGES):
        j1 = min(j0 + MAX_STAGES, k)
        KERNEL(ptr(ss_run[j0]), cap, ptr(thr[j0:]), j1 - j0, ptr(valid),
               ptr(b_sel), ptr(n_live), ptr(counts[j0]), n_img,
               ss_run.device.index, stream_of(ss_run))
    return valid
