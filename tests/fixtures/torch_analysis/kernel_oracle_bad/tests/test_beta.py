"""Fixture test outside tests/test_torch_*.py: it names the pair, and
does not count for the port."""

from repro_torch.kernels.ops import beta_sum
from repro_torch.kernels.ref import beta_sum_ref


def test_beta(x):
    assert beta_sum(x) == beta_sum_ref(x)
