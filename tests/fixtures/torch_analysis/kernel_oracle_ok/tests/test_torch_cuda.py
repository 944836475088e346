"""Fixture card test: races gamma_sum against gamma_sum_ref."""

from repro_torch.kernels.ops import gamma_sum
from repro_torch.kernels.ref import gamma_sum_ref


def test_gamma(x):
    assert gamma_sum(x) == gamma_sum_ref(x)
