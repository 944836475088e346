"""j_per_image: the card's energy counter (NVML, millijoules) over the
window, divided by the images completed in it."""


def read(run):
    n = sum(run.images)
    if run.energy_j is None or not n or run.energy_j <= 0:
        return None
    return run.energy_j / n
