"""Fixture: the plan compiler is the one place that builds the IR."""


def compile_segment(n, SegmentPlan):
    return SegmentPlan(spans=((0, n),), caps=(n,))
