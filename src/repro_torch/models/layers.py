"""Shared building blocks (port of ``src/repro/models/layers.py``).

Weights take the dtype they are given (float32 by default, as the
reference launcher makes them; bfloat16 where a model does not fit the
card in float32). They are drawn in float32 and cast tensor by tensor, so
a bfloat16 model never holds a float32 copy of itself. Norm scales stay
float32, as in the reference. Parameters keep the reference's leaf names
and its (d_in, d_out) orientation, so ``x @ w`` reads as it does there and
a converted JAX param tree loads leaf for leaf. Every RMSNorm goes through
the kernel set it is given (the CUDA kernel on the card when serving,
the plain ``kernels.ref.rmsnorm_ref`` when training: the kernels have no
backward).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels.ops import KERNELS, KernelSet


def truncated_normal_(shape: tuple[int, ...], scale: float, *, device,
                      dtype: torch.dtype = torch.float32,
                      generator: torch.Generator | None = None
                      ) -> nn.Parameter:
    """Standard normal truncated to [-2, 2], times ``scale``: drawn in
    float32, then cast to ``dtype``."""
    t = torch.empty(shape, device=device, dtype=torch.float32)
    nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    return nn.Parameter(t.mul_(scale).to(dtype))


def dense_init(d_in: int, d_out: int, *, device,
               dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None) -> nn.Parameter:
    return truncated_normal_((d_in, d_out), d_in ** -0.5, device=device,
                             dtype=dtype, generator=generator)


def embed_init(vocab: int, d: int, *, device,
               dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None) -> nn.Parameter:
    return truncated_normal_((vocab, d), 1.0, device=device, dtype=dtype,
                             generator=generator)


# --- RMSNorm --------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            kernels: KernelSet = KERNELS) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, cast to x.dtype."""
    return kernels.rmsnorm(x, scale, eps=eps)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((d,), dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor,
                kernels: KernelSet = KERNELS) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps, kernels)


# --- SwiGLU MLP -------------------------------------------------------------------


def mlp(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, device,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.w_gate = dense_init(d, d_ff, **kw)
        self.w_up = dense_init(d, d_ff, **kw)
        self.w_down = dense_init(d_ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.w_gate, self.w_up, self.w_down, x)


# --- relu^2 MLP (Nemotron-H's experts and shared expert) ---------------------------


class Relu2MLP(nn.Module):
    """``down(relu(x @ up) ** 2)``."""

    def __init__(self, d: int, d_ff: int, *, device,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.w_up = dense_init(d, d_ff, **kw)
        self.w_down = dense_init(d_ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x @ self.w_up).square() @ self.w_down


# --- fc-GELU-fc MLP (granite, whisper) ----------------------------------------------


class GeluMLP(nn.Module):
    """``gelu(x @ w1 + b1) @ w2 + b2`` with the tanh approximation, which
    is ``jax.nn.gelu``'s default; the biases start at zero."""

    def __init__(self, d: int, d_ff: int, *, device,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.w1 = dense_init(d, d_ff, **kw)
        self.b1 = nn.Parameter(torch.zeros((d_ff,), device=device,
                                           dtype=dtype))
        self.w2 = dense_init(d_ff, d, **kw)
        self.b2 = nn.Parameter(torch.zeros((d,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x @ self.w1 + self.b1, approximate="tanh") @ self.w2 \
            + self.b2


# --- Rotary position embeddings ---------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """(head_dim/2,) inverse frequencies, float64 on the host."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


#: float32 inverse frequencies per (head_dim, theta, device), built once
_INV_FREQ: dict[tuple, torch.Tensor] = {}
#: M-RoPE's channel -> position stream ids per (sections, device)
_SECTION_IDS: dict[tuple, torch.Tensor] = {}


def _once(cache: dict, key: tuple, build) -> torch.Tensor:
    """``cache[key]``, built by ``build()`` on the first call. The build
    runs outside any dispatch mode, so a counting mode (``launch.costs``)
    sees the same ops in a step whether or not the table existed before."""
    table = cache.get(key)
    if table is None:
        with _disable_current_modes():
            table = cache[key] = build()
    return table


def rope_table(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """``rope_frequencies(head_dim, theta)`` cast to float32 on ``device``,
    built on the first call and cached: later calls copy nothing to the
    card, so a step neither waits on the host nor breaks a CUDA graph's
    capture."""
    return _once(_INV_FREQ, (head_dim, float(theta), device),
                 lambda: torch.as_tensor(rope_frequencies(head_dim, theta),
                                         dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by per-token positions (..., seq):
    half-split rotation in float32, with the inverse frequencies held in
    float32 as the reference's jnp arrays hold them."""
    inv_freq = rope_table(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq  # (..., S, hd/2)
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (..., S, heads, hd) by angles (..., S, hd/2)
    in float32, cast back to x.dtype."""
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the (t, h, w) position streams of
    ``positions`` (3, ..., S) own disjoint channel sections of the rotary
    half-dim (``sections`` sums to head_dim // 2). Each channel's angle is
    picked from its stream by index; the reference's one-hot einsum adds
    exact zeros, so the angles are the same bits."""
    head_dim = x.shape[-1]
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    inv_freq = rope_table(head_dim, theta, x.device)
    angles_all = positions[..., None].float() * inv_freq  # (3, ..., S, hd/2)
    sec_id = _once(_SECTION_IDS, (tuple(sections), x.device),
                   lambda: torch.as_tensor(np.repeat(np.arange(3), sections),
                                           device=x.device))
    index = sec_id.expand(1, *angles_all.shape[1:])
    return _rotate(x, angles_all.gather(0, index)[0])


# --- Sinusoidal positions (whisper's encoder) ------------------------------


def sinusoid_pos(seq: int, d: int, *, device) -> torch.Tensor:
    """Whisper-style sinusoidal position table (seq, d) in float64, built
    in numpy as the reference builds it; the caller casts it."""
    half = d // 2
    log_timescale = np.log(10000.0) / max(half - 1, 1)
    inv = np.exp(-log_timescale * np.arange(half))
    pos = np.arange(seq)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    return torch.as_tensor(table, device=device)


# --- Losses -----------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in float32. logits (B, S, V), labels (B, S): the
    log-partition minus the gold logit (a gather, where the reference sums
    a one-hot product: the same value, exactly), averaged over the tokens,
    or over ``mask`` with the count floored at 1."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
