"""``setup_s``: everything before the window (process start, imports, the
inputs made from the seed, the program's objects, kernels built or loaded,
warm-up), host clock, closed by a synchronise."""


def read(run):
    return run["setup_s"]
