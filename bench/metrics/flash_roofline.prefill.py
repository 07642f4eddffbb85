"""flash_roofline.prefill: least time of the traced prefills' flash
attention calls over the device time of the flash_fwd_* kernels in them,
in %."""

from bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "prefill", "flash", "flash_fwd_")
