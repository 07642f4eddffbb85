"""host_waits.train: host waits (``spans.WAITS``) inside a training step's
spans, per step."""

from bench.harness.spans import train_host_waits


def read(run):
    return train_host_waits(run)
