"""gmm_roofline.prefill: least time of the traced prefills' grouped
matmuls over the device time of the gmm_* kernels in them, in %."""

from bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "prefill", "gmm", "gmm_")
