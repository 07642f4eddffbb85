"""launches.decode: median device operations (kernels, copies, sets) a
decode step (``gs.decode``) launched."""

from bench.harness.spans import launches


def read(run):
    return launches(run, "decode")
