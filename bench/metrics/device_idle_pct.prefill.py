"""device_idle_pct.prefill: share of the traced prefill phases' wall time in
which no kernel, copy or set ran on the device, in %."""

from bench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "prefill")
