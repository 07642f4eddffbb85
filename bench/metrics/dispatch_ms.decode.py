"""dispatch_ms.decode: median host time of a decode step's span
(``gs.decode``), in ms."""

from bench.harness.spans import dispatch_ms


def read(run):
    return dispatch_ms(run, "decode")
