"""The port's static analysis (``python -m repro_torch.analysis``).

The counterpart of ``repro.analysis`` for ``repro_torch``: the same
framework and rule ids, pointed at the port's modules and read in
PyTorch's idiom.  The invariants the port's correctness rests on become
lint-time errors instead of runtime surprises:

==================  =====================================================
TRACE_BRANCH        host ``if``/``while``/``assert``/ternary on a tensor
                    value inside a root (``rules.trace_safety.ROOTS``: the
                    port's counterparts of the reference's ``jax.jit`` /
                    ``pallas_call`` sites, and the bodies of
                    ``torch.autograd.Function`` forward/backward)
TRACE_CONCRETE      ``bool()``/``int()``/``float()``/``.item()``/
                    ``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")``/
                    ``np.asarray()`` on a tensor value inside a root (a
                    device-to-host sync; raises under ``FakeTensorMode``)
JIT_CACHE           ``torch.compile`` in a loop or of an inline-invoked
                    lambda; a ``native.Kernel(...)`` handle built anywhere
                    but at a module's top level
TAIL_BACKEND        packed-tail backend string literals not in the
                    allowed set (``kernels.packed_tail.BACKENDS`` +
                    ``"auto"``)
PLAN_GEOMETRY       hand-rolled plan-IR construction (``SegmentPlan``,
                    ``SlotLayout``, ...) outside ``src/repro_torch/plan/``
LANE_BLOCK          hardcoded ``(8, 128)`` lane-block/tile literals
                    outside ``src/repro_torch/kernels/autotune.py``
KERNEL_REF_TWIN     public kernel wrapper of ``kernels/ops.py`` without a
                    ``*_ref`` twin in ``kernels/ref.py`` / ``kernels/ops.py``
KERNEL_REF_TEST     kernel/twin pair never named together by one
                    ``tests/test_torch_*.py`` file
DEPRECATED_SURFACE  internal use of the deprecated serving surfaces
                    (legacy ``DetectorService`` kwargs, dict-style
                    ``stats()[...]`` access)
DEAD_STORE          assignment overwritten before any use
HOST_SYNC           host materialisation or device synchronisation in the
                    streaming hot path (``stream/engine.py``,
                    ``stream/video.py``) without a justified suppression
SUPPRESS            malformed ``# repro_torch: ignore[...]`` comments
==================  =====================================================

Suppression: ``# repro_torch: ignore[RULE] reason`` on the finding's line
(or on a comment-only line directly above it).  The reason is mandatory
and ``*`` is not a rule.  The reference gate's ``# repro: ignore[...]``
marker does not suppress anything here, nor does this one there.

The package is stdlib-only (``ast``): it imports no ``torch``, no
``numpy``, no ``jax`` and nothing of ``repro``, and never imports the code
it analyses.
"""

from .core import Finding, Rule, RULES, register, rule_ids
from .engine import AnalysisResult, run_analysis
from .cli import main
from . import rules as _rules                # noqa: F401  (registers rules)

__all__ = ["Finding", "Rule", "RULES", "register", "rule_ids",
           "AnalysisResult", "run_analysis", "main"]
