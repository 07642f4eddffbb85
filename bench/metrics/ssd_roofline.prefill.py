"""ssd_roofline.prefill: least time of the traced prefills' SSD scans
over the device time of the five ssd_* kernels in them, in %."""

from bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "prefill", "ssd", "ssd_")
