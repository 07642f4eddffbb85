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

LAUNCHES: dict[str, int] = {"flash_attention": 0, "fused_rmsnorm": 0,
                             "ssd_scan": 0, "grouped_matmul": 0}

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


_CUDA_ERROR_INVALID_VALUE = 1  # an entry point refuses the sizes it got


def _raise_on(name: str, err: int) -> None:
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: the kernel refuses these sizes "
                         f"(cudaErrorInvalidValue)")
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
                  eps: float = 1e-5, group: int | None = None
                  ) -> torch.Tensor:
    """x (..., d) RMS-normalized over the last axis and scaled; with
    ``group``, over each run of ``group`` channels of it (Mamba-2's
    grouped gated norm), scale still (d,)."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps, group=group)
    _check_cuda("fused_rmsnorm", x, scale)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"fused_rmsnorm: scale must be float32 ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    group = group or d
    if d % group:
        raise ValueError(f"fused_rmsnorm: group {group} does not divide {d}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_rmsnorm: float32 or bfloat16 x, got {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("fused_rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.library().gs_rmsnorm(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), y.data_ptr(),
            x.numel() // group, group, d // group, float(eps),
            torch.cuda.current_stream().cuda_stream)
    _raise_on("fused_rmsnorm", err)
    LAUNCHES["fused_rmsnorm"] += 1
    return y


_SSD_CHUNK = 64  # tokens of the SSD kernels' own chunk (kLk in ssd_scan.cu)
_SSD_SUMS = 5  # float arrays of _SSD_CHUNK per chunk (kSums in ssd_scan.cu)


def ssd_workspace(Bsz: int, S: int, H: int, G: int, P: int, N: int,
                  device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD kernels' float32 scratch on ``device`` (the caching
    allocator, on the current stream): the per-chunk log-decay sums
    (B, H, nc, 5, 64), each chunk's C.B^T per B/C group (B, nc, G, 64, 64)
    and the chunk states (B, nc, H, P, N), nc = ceil(S / 64); the kernels
    fill each before they read it."""
    nc = -(-S // _SSD_CHUNK)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((Bsz, H, nc, _SSD_SUMS, _SSD_CHUNK), **f32),
            torch.empty((Bsz, nc, G, _SSD_CHUNK, _SSD_CHUNK), **f32),
            torch.empty((Bsz, nc, H, P, N), **f32))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (B,S,H,P), dt (B,S,H), A/D (H,), B/C (B,S,G,N),
    initial_state (B,H,P,N) -> (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) float32). Any S is taken: the kernels mask a ragged last
    chunk instead of shrinking ``chunk`` to a divisor of S. They chunk at
    64 tokens (``_SSD_CHUNK``) whatever ``chunk`` is, since the function
    does not depend on where chunks fall. The kernel takes P <= 64 and
    N <= 128 and refuses sizes beyond them, or a chunk below 1, with
    cudaErrorInvalidValue, raised here as ValueError."""
    given = [x, dt, A, B, C, D] + ([] if initial_state is None
                                   else [initial_state])
    if all(t.device.type == "cpu" for t in given):
        return ref.ssd_ref(x, dt, A, B, C, D, initial_state)
    _check_cuda("ssd_scan", *given)
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (tuple(B.shape) != (Bsz, S, G, N) or tuple(C.shape) != tuple(B.shape)
            or tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,) or G < 1 or H % G):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} do not fit")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: float32 or bfloat16 x with B and C of "
                        f"the same type, got {x.dtype}, {B.dtype}, {C.dtype}")
    f32 = [dt, A, D] + ([] if initial_state is None else [initial_state])
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("ssd_scan: dt, A, D and initial_state must be float32")
    if any(t.stride(-1) != 1 for t in (x, B, C)) or not (
            A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_scan: x, B and C need a contiguous last "
                         "dimension, A and D must be contiguous")
    if initial_state is not None and (
            tuple(initial_state.shape) != (Bsz, H, P, N)
            or not initial_state.is_contiguous()):
        raise ValueError(f"ssd_scan: initial_state must be contiguous "
                         f"{(Bsz, H, P, N)}, got {tuple(initial_state.shape)}")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    sums, cb, states = ssd_workspace(Bsz, S, H, G, P, N, x.device)
    s0 = 0 if initial_state is None else initial_state.data_ptr()
    with torch.cuda.device(x.device):
        err = build.library().gs_ssd_scan(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), D.data_ptr(), s0, y.data_ptr(),
            final.data_ptr(), sums.data_ptr(), cb.data_ptr(),
            states.data_ptr(),
            Bsz, S, H, G, P, N, int(chunk),
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            torch.cuda.current_stream().cuda_stream)
    _raise_on("ssd_scan", err)
    LAUNCHES["ssd_scan"] += 1
    return y, final


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert matmul (E,C,d) @ (E,d,f) -> (E,C,f): float32
    accumulation, the output in x's dtype."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w)
    _check_cuda("grouped_matmul", x, w)
    E, C, d = x.shape
    f = w.shape[-1]
    if tuple(w.shape) != (E, d, f):
        raise ValueError(f"grouped_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not fit")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: float32 or bfloat16 x and w of one "
                        f"type, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")
    o = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = build.library().gs_grouped_matmul(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), o.data_ptr(),
            E, C, d, f, torch.cuda.current_stream().cuda_stream)
    _raise_on("grouped_matmul", err)
    LAUNCHES["grouped_matmul"] += 1
    return o


@dataclasses.dataclass(frozen=True)
class KernelSet:
    """The functions the model's prefill/decode call for attention,
    normalisation, the SSD scan and the expert FF. ``KERNELS`` (the
    wrappers above) is what the model and the engine always use; ``PLAIN``
    exists so that a check can run the same model through the plain
    versions on the card and compare."""

    flash_attention: Callable[..., torch.Tensor]
    rmsnorm: Callable[..., torch.Tensor]
    ssd_scan: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    grouped_matmul: Callable[..., torch.Tensor]


KERNELS = KernelSet(flash_attention=flash_attention, rmsnorm=fused_rmsnorm,
                    ssd_scan=ssd_scan, grouped_matmul=grouped_matmul)
PLAIN = KernelSet(flash_attention=ref.flash_attention_ref,
                  rmsnorm=ref.rmsnorm_ref, ssd_scan=ref.ssd_ref,
                  grouped_matmul=ref.grouped_matmul_ref)
