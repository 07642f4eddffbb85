"""dispatch_ms.decode.attn: median, over decode steps, of the host time in
the step's attention layers (``gs.attn``), in ms."""

from bench.harness.spans import kind_ms


def read(run):
    return kind_ms(run, "decode", "attn")
