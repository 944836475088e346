"""Fixture test: names beta_sum but never its twin."""

from repro_torch.kernels.ops import beta_sum


def test_beta(x):
    assert beta_sum(x) is not None
