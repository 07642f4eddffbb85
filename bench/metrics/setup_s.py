"""setup_s: process start to the start of the window (build, weights,
warm-up), host clock."""


def read(run):
    return run.setup_s
