"""setup_s: seconds from the run's start to its first timed call, through
its first process: imports, the CUDA context, the pool made and written,
the kernels built or loaded, one warm-up round trip."""


def read(run):
    return run.setup_s
