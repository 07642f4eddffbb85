"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): the rates every roofline and MFU here divides by."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # float32 on the CUDA cores: TF32 off
HBM_BYTES = 3.35e12


def flops(dtype: str) -> float:
    """Peak FLOP/s at a configuration's dtype (float32 with TF32 off, as
    every configuration here states)."""
    if dtype == "bfloat16":
        return BF16_FLOPS
    if dtype == "float32":
        return F32_FLOPS
    raise ValueError(f"no peak for {dtype!r}")


def least_seconds(nflops: float, nbytes: float, dtype: str) -> float:
    """The roofline: the larger of operations over peak FLOP/s and bytes
    over HBM bandwidth."""
    return max(nflops / flops(dtype), nbytes / HBM_BYTES)
