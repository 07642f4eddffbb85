"""dispatch_ms.decode.mamba: median, over decode steps, of the host time in
the step's Mamba mixers (``gs.mamba``), in ms."""

from bench.harness.spans import kind_ms


def read(run):
    return kind_ms(run, "decode", "mamba")
