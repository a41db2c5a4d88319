"""Seconds from the process's start to the first timed request: imports,
the CUDA context, the kernel library (built in a checkout's first run),
the track tables, the model and the warm-up request's graph capture."""


def read(run):
    return run.setup_s
