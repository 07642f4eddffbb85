"""Plain PyTorch versions of the kernels (port of ``src/repro/kernels/ref.py``).

The simplest correct implementations — dense masks, float32 math — that
the CPU tests compare against and that ``chip_smoke.py`` holds each CUDA
kernel against on the card. The wrappers in ``ops.py`` run these only for
tensors that lie on the CPU. ``rmsnorm_ref``, the reference's jnp
``rmsnorm``, is also the training path's norm (``models.train_paths``).
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


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            initial_state: torch.Tensor | None = None, *,
            chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential (token-by-token) SSD recurrence, the ground truth.

    x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N), D (H,), initial_state
    (B,H,P,N). h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t; y_t = C_t . h_t +
    D x_t. Returns (y in x's dtype, final state float32). ``chunk`` is
    taken and ignored: it exists only so that ``ops.PLAIN`` can stand in
    for the chunked kernel with the same call; the recurrence has no
    chunks.
    """
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hpg = H // G
    x_, dt_, A_ = x.float(), dt.float(), A.float()
    B_ = B.float().repeat_interleave(hpg, dim=2)  # (B,S,H,N)
    C_ = C.float().repeat_interleave(hpg, dim=2)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dt_[:, t] * A_)  # (B,H)
        h = h * dA[..., None, None] + (dt_[:, t, :, None, None]
                                       * x_[:, t, :, :, None]
                                       * B_[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, C_[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x_)
    y = y + x_ * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert matmul. x (E,C,d), w (E,d,f) -> (E,C,f), float32
    accumulation, cast back to x.dtype."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return out.to(x.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5, *, group: int | None = None
                ) -> torch.Tensor:
    """RMSNorm over the last axis, float32 internals, cast back to x.dtype;
    with ``group``, over each run of ``group`` channels of it."""
    x32 = x.float()
    d = x.shape[-1]
    if group is not None:
        x32 = x32.unflatten(-1, (d // group, group))
        scale = scale.view(d // group, group)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).reshape(x.shape).to(x.dtype)
