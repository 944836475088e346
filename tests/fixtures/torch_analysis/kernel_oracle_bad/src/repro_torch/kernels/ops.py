"""Fixture ops module: ``alpha_sum`` has no twin (KERNEL_REF_TWIN);
``beta_sum`` has one, but no tests/test_torch_*.py file names the pair
(KERNEL_REF_TEST); the launch counters from .native are not kernels."""

from .native import launches, reset_launches

__all__ = ["alpha_sum", "beta_sum", "launches", "reset_launches"]


def alpha_sum(x):
    return x.sum()


def beta_sum(x):
    return x.sum() * 2
