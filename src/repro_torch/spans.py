"""Named spans of the port's work, on ``torch.profiler``'s clock.

``span(name)`` is a profiler range named ``repro_torch.<name>`` while a
profiler is recording, and one shared null context otherwise (a check of
under 1 us a call).  The range is PyTorch's fast record function, which
the profiler records as a host operation: about 1 us a call where a
``torch.profiler.record_function`` costs 9-18 us, and no device-side
``gpu_user_annotation`` event, which a reader of the trace would take
for work of the device.  The profiler is the store and the exporter
(``export_chrome_trace``); spans share its clock with the device's
operations, so an idle gap of the device falls inside the innermost span
that was open on the host.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch."
_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``repro_torch.<name>`` profiler range, or the shared null context
    when no profiler is recording."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(PREFIX + name)
    return _NULL
