"""mfu.train: model FLOPs of the traced train phases over their wall time
at the published peak of the configuration's dtype, in %."""

from bench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train")
