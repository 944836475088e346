"""Seeded TRACE_CONCRETE fixture: ``integral_image`` is a root of
``ROOTS`` (its ``img`` traced); three host materialisations of it, one
through a helper."""


def _scale(v):
    return float(v.max()) * v                  # 3: float() in a callee


def integral_image(img):
    host = img.cpu()                           # 1: .cpu()
    rows = img.sum(1).tolist()                 # 2: .tolist()
    return _scale(img) + host.sum() + len(rows)
