"""Kernel wrappers (port of ``src/repro/kernels/ops.py``).

Each wrapper takes its plain version (``ref.py``) only for tensors that lie
on the CPU. For CUDA tensors it checks what the kernel takes, makes their
device the current one, launches the hand-written CUDA kernel on that
device's current stream and raises if the launch fails: there is no
fallback. ``LAUNCHES`` counts the kernel launches of each wrapper (CPU
calls are not counted), so a run can show that its path went through the
kernels.

The kernels mask ragged tails themselves, so the reference's divisor-block
search (``_fit_block``) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels import build, ref

LAUNCHES: dict[str, int] = {"flash_attention": 0, "fused_rmsnorm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must all lie on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """GQA flash attention. q (B,Sq,H,D); k/v (B,Sk,Hkv,D) -> (B,Sq,H,D)."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_cuda("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or (Bk, Dk) != (B, D):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if Hkv < 1 or H % Hkv or not 1 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs H % Hkv == 0 and "
                         f"1 <= D <= {_MAX_HEAD_DIM}, got H={H} Hkv={Hkv} D={D}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: float32 or bfloat16 for all of "
                        f"q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = build.library().gs_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, Sq, Sk, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    _raise_on("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return o


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) RMS-normalized over the last axis and scaled."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    _check_cuda("fused_rmsnorm", x, scale)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"fused_rmsnorm: scale must be float32 ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_rmsnorm: float32 or bfloat16 x, got {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("fused_rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.library().gs_rmsnorm(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), y.data_ptr(),
            x.numel() // d, d, float(eps),
            torch.cuda.current_stream().cuda_stream)
    _raise_on("fused_rmsnorm", err)
    LAUNCHES["fused_rmsnorm"] += 1
    return y


@dataclasses.dataclass(frozen=True)
class KernelSet:
    """The two functions the model's prefill/decode call for attention and
    normalisation. ``KERNELS`` (the wrappers above) is what the model and
    the engine always use; ``PLAIN`` exists so that a check can run the same
    model through the plain versions on the card and compare."""

    flash_attention: Callable[..., torch.Tensor]
    rmsnorm: Callable[..., torch.Tensor]


KERNELS = KernelSet(flash_attention=flash_attention, rmsnorm=fused_rmsnorm)
PLAIN = KernelSet(flash_attention=ref.flash_attention_ref,
                  rmsnorm=ref.rmsnorm_ref)
