"""The arithmetic of the plain reference and of its lower-precision
controls. Every matrix product of the reference goes through ``Arith.mm``
or ``Arith.einsum``, whose operands are rounded first:

- ``float32``: not at all (TF32 must be off: ``reference.lm`` turns it off);
- ``tf32``: to TF32's 10-bit mantissa, round to nearest even, so an f32
  product of the rounded operands is a TF32 tensor-core product (its
  11-bit products are exact in float32);
- ``fp8``: to float8 e4m3 with one scale per slice along the contracted
  dimension (amax / 448), the usual fp8 GEMM;
- ``bf16``: to bfloat16, the operands a bf16 program multiplies (not a
  control: the witness that a bf16 configuration's rounding alone moves
  the reference as far as the program sits from it).

Elementwise work (norms, softmax, activations, the SSM recurrence) stays
float32 in every mode. Under autograd (the training control) the rounding
passes gradients straight through, and in ``tf32`` the gradient arriving
at each product is rounded too, as TF32 rounds the backward's operands.
"""

from __future__ import annotations

import torch

MODES = ("float32", "tf32", "fp8", "bf16")
_E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits (nearest, ties to even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x quantised to e4m3 with a scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Rounded(torch.autograd.Function):
    """Forward: ``fn(x)``; backward: the gradient unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Forward: x; backward: ``fn`` of the gradient."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Arith:
    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}; known: {MODES}")
        self.mode = mode

    def _r(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.float()
        if self.mode == "tf32":
            return _Rounded.apply(x, round_tf32)
        if self.mode == "fp8":
            return _Rounded.apply(x, lambda t: round_fp8(t, dim))
        if self.mode == "bf16":
            return _Rounded.apply(x, lambda t: t.bfloat16().float())
        return x

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32" and y.requires_grad:
            return _RoundGrad.apply(y, round_tf32)
        return y

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., k) @ b (k, n) in float32."""
        return self._out(self._r(a, -1) @ self._r(b, 0))

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        """Two-operand einsum whose single contracted index is scaled over
        (for fp8)."""
        ins, out = spec.split("->")
        sa, sb = ins.split(",")
        (c,) = (set(sa) & set(sb)) - set(out)
        return self._out(torch.einsum(spec, self._r(a, sa.index(c)),
                                      self._r(b, sb.index(c))))
