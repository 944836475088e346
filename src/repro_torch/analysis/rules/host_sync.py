"""Host-sync discipline for the streaming hot path.

The device-resident stream contract (``StreamConfig.device_state``) is
that a steady-state frame moves exactly three things across the
host<->device boundary: the new frame in, the step's scalar verdict out,
and the decoded survivor slot list out.  Everything else — reference
pixels, survivor bitmaps, drift, frame counters — stays on the device
inside :class:`repro_torch.stream.StreamState`.

``HOST_SYNC`` keeps that contract visible in the diff: any host
materialisation or device synchronisation inside ``stream/engine.py`` or
``stream/video.py`` must carry a ``# repro_torch: ignore[HOST_SYNC] <why>``
justification naming which side of the contract it is (frame intake,
scalar verdict, slot decode, keyframe upload), or pointing at the
roadmap entry that logs it.  An unjustified one is a new
synchronisation point in the hot path.

Flagged: the reference's three (``np.asarray``/``np.array``,
``device_get``, ``.item()``) and PyTorch's ``.cpu()``, ``.numpy()``,
``.tolist()``, ``.to("cpu")``, ``torch.cuda.synchronize()`` and an
event's or stream's ``.synchronize()``.  A conversion chained onto a call
already flagged (``x.cpu().numpy()``, ``np.asarray(x.cpu())``) is the
same sync and is not flagged again.
"""

from __future__ import annotations

import ast

from ..core import Finding, Rule, SourceFile, register

# the device-resident hot path: every host materialisation here is a
# potential per-frame sync and must be one of the contract's endpoints
_HOT_FILES = ("stream/engine.py", "stream/video.py")
_NP_NAMES = ("np", "numpy")
_NP_FUNCS = ("asarray", "array")
_HOST_METHODS = ("item", "cpu", "numpy", "tolist")


def _is_cpu_literal(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _sync_kind(call: ast.Call) -> str | None:
    """What the call is, if it is a host sync / materialisation."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in _NP_FUNCS and isinstance(fn.value, ast.Name) \
            and fn.value.id in _NP_NAMES:
        return f"{fn.value.id}.{fn.attr}(...)"
    if fn.attr == "device_get":
        return f"{fn.attr}(...)"
    if fn.attr in _HOST_METHODS and not call.args and not call.keywords:
        return f".{fn.attr}()"
    if fn.attr == "to" and (
            any(_is_cpu_literal(a) for a in call.args[:1])
            or any(kw.arg == "device" and _is_cpu_literal(kw.value)
                   for kw in call.keywords)):
        return '.to("cpu")'
    if fn.attr == "synchronize":
        v = fn.value
        if isinstance(v, ast.Attribute) and v.attr == "cuda" \
                and isinstance(v.value, ast.Name) and v.value.id == "torch":
            return "torch.cuda.synchronize()"
        return ".synchronize()"
    return None


def _chained_on(call: ast.Call, flagged: set[int]) -> bool:
    """Is ``call`` a conversion of a call already flagged (its receiver,
    or the first argument of ``np.asarray``/``np.array``)?"""
    fn = call.func
    inner = [fn.value] if isinstance(fn, ast.Attribute) else []
    inner += call.args[:1]
    return any(isinstance(n, ast.Call) and id(n) in flagged for n in inner)


@register
class HostSyncRule(Rule):
    id = "HOST_SYNC"
    summary = ("host materialisation (np.asarray/np.array/device_get/"
               ".item()/.cpu()/.numpy()/.tolist()/.to('cpu')) or "
               "synchronize() in the streaming hot path without a "
               "justified suppression")

    def check(self, src: SourceFile, project) -> list[Finding]:
        if not src.rel.endswith(_HOT_FILES):
            return []
        findings = []
        flagged: set[int] = set()
        # ast.walk visits a chain's outer call first; walk the calls
        # innermost first so a chain is flagged once, at its sync
        calls = [n for n in ast.walk(src.tree) if isinstance(n, ast.Call)]
        for node in reversed(calls):
            what = _sync_kind(node)
            if what is None:
                continue
            chained = _chained_on(node, flagged)
            flagged.add(id(node))
            if chained:
                continue
            findings.append(Finding(
                src.rel, node.lineno, node.col_offset + 1, self.id,
                f"{what} in the streaming hot path is a host sync / "
                f"host-side materialisation; keep stream state "
                f"device-resident, or justify which endpoint of the "
                f"transfer contract this is with "
                f"`# repro_torch: ignore[HOST_SYNC] <why>`"))
        return sorted(findings)
