"""Fixture ref module: only beta_sum has a twin."""


def beta_sum_ref(x):
    return x.sum() * 2
