"""device_idle_pct.train: share of the traced train phases' wall time in
which no kernel, copy or set ran on the device, in %."""

from bench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "train")
