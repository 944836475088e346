import os
import sys
import types

import pytest

# tests see the real single-device CPU backend (the 512-device override is
# ONLY for launch/dryrun.py); distributed tests that need a few devices
# spawn subprocesses or use tests/distributed/conftest.py.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# fixtures/ holds deliberately-violating inputs for the repro.analysis rule
# tests (including test_*.py files inside mirrored repo trees) — data, not
# tests; keep pytest from collecting them
collect_ignore = ["fixtures"]


# ---------------------------------------------------------------------------
# hypothesis degradation guard: when hypothesis is not installed (it is a
# dev-only dependency, see requirements-dev.txt), property-based tests must
# *skip* instead of killing collection of their whole module with an
# ImportError.  We install a minimal stub that mimics the API surface used
# by this suite (given / settings / strategies.*); any test decorated with
# the stub's ``given`` skips at call time.
# ---------------------------------------------------------------------------

def _install_hypothesis_stub() -> None:
    stub = types.ModuleType("hypothesis")
    stub.IS_STUB = True

    def given(*_a, **_k):
        def deco(fn):
            def wrapper(*_fa, **_fk):
                pytest.skip("hypothesis not installed (stubbed by conftest)")
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    class _Strategy:
        """Inert placeholder for strategy objects (never drawn from)."""

        def __repr__(self):
            return "<stub-strategy>"

        def map(self, *_a, **_k):
            return self

        def filter(self, *_a, **_k):
            return self

        def flatmap(self, *_a, **_k):
            return self

    strategies = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "lists", "sampled_from", "booleans",
                  "tuples", "just", "one_of", "composite", "text"):
        setattr(strategies, _name, lambda *_a, **_k: _Strategy())

    stub.given = given
    stub.settings = settings
    stub.strategies = strategies
    stub.assume = lambda *_a, **_k: None
    stub.HealthCheck = types.SimpleNamespace(all=lambda: [])
    sys.modules["hypothesis"] = stub
    sys.modules["hypothesis.strategies"] = strategies


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no CPU "
        "mode); skips without one")
