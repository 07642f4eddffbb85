"""gmm_roofline.decode: least time of the traced decode steps' grouped
matmuls over the device time of the gmm_* kernels in them, in %."""

from bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "decode", "gmm", "gmm_")
