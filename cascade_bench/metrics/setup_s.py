"""setup_s: from the process's start to the first timed flush: imports,
the CUDA context, the kernels (built only by a checkout's first run), the
cascade, the scene pool and the warm-up flushes."""


def read(run):
    return run.setup_s
