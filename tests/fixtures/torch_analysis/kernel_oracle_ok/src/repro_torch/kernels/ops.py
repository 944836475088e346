"""Fixture ops module: gamma_sum has a twin and a card test that races
the pair — clean."""

from .native import launches, reset_launches

__all__ = ["gamma_sum", "launches", "reset_launches"]


def gamma_sum(x):
    return x.sum() * 3
