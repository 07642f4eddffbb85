"""host_waits.prefill: mean host waits (``spans.WAITS``) inside a prefill
(``gs.prefill``)."""

from bench.harness.spans import host_waits


def read(run):
    return host_waits(run, "prefill")
