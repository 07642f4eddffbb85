"""device_ms.decode: median, over decode steps (``gs.decode``), of the
device time of the kernels and copies each step launched, in ms."""

from bench.harness.spans import device_ms


def read(run):
    return device_ms(run, "decode")
