"""Seeded TRACE_BRANCH fixture: host branches on the traced ``img`` of
the ``integral_image`` root."""


def integral_image(img):
    if img.max() > 0:                          # 1: host `if`
        img = img - 1
    return img if img.min() >= 0 else -img     # 2: host ternary
