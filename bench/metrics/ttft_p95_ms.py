"""ttft_p95_ms: 95th percentile over every request of the window of
the time from the host issuing its batch's prefill to its first token on
the device (CUDA events)."""

from bench.harness.record import p95


def read(run):
    return p95(run.samples.get("ttft_ms"))
