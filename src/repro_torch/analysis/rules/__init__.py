"""Rule suite registration.

Importing this package registers every built-in rule with
:data:`repro_torch.analysis.core.RULES`.  Add a module here (and import it
below) to add a rule; the engine, CLI, ``--select``, ``--list-rules``,
and the suppression checker pick it up automatically.
"""

from __future__ import annotations

from . import (  # noqa: F401  (imported for their @register side effects)
    dead_store,
    deprecation,
    host_sync,
    kernel_oracle,
    plan_contracts,
    trace_safety,
)
