"""host_waits.decode: mean host waits (``spans.WAITS``) inside a decode
step (``gs.decode``)."""

from bench.harness.spans import host_waits


def read(run):
    return host_waits(run, "decode")
