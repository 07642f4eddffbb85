"""device_idle_pct.decode: share of the traced decode phases' wall time in
which no kernel, copy or set ran on the device, in %."""

from bench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "decode")
