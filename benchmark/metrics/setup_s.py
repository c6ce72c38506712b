"""Set-up time: process start to the first measured step (imports, input
files, weights, loader and producers, kernel loads, the warm-up steps)."""


def read(run):
    return run.prog.setup_s
