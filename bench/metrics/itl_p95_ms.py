"""itl_p95_ms: 95th percentile over every gap between consecutive
output tokens of every request of the window (CUDA events after each
argmax)."""

from bench.harness.record import p95


def read(run):
    return p95(run.samples.get("itl_ms"))
