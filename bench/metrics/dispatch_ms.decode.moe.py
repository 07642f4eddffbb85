"""dispatch_ms.decode.moe: median, over decode steps, of the host time in
the step's MoE FFs (``gs.moe``), in ms."""

from bench.harness.spans import kind_ms


def read(run):
    return kind_ms(run, "decode", "moe")
