"""dispatch_ms.decode.ff: median, over decode steps, of the host time in
the step's dense FFs (``gs.ff``), in ms."""

from bench.harness.spans import kind_ms


def read(run):
    return kind_ms(run, "decode", "ff")
