"""Plain PyTorch versions of the kernels (port of ``src/repro/kernels/ref.py``).

The simplest correct implementations — dense masks, float32 math — that
the CPU tests compare against and that ``chip_smoke.py`` holds each CUDA
kernel against on the card. The wrappers in ``ops.py`` run these only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Dense-mask GQA attention. q (B,Sq,H,D); k/v (B,Sk,Hkv,D)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    groups = H // Hkv
    qg = q.reshape(B, Sq, Hkv, groups, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    scores = scores / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, float32 internals, cast back to x.dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)
