"""images_per_s: images whose flush completed in the window, over the
window's seconds (host clock, first flush sent to last rects back)."""


def read(run):
    n = sum(run.images)
    return n / run.window_s if n and run.window_s > 0 else None
