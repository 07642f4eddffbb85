"""Grouped-query attention with causal / sliding-window masking and a ring
KV cache (port of ``src/repro/models/attention.py``).

Prefill attention runs through the flash-attention kernel of the kernel set
it is given. ``decode_attention`` stays plain torch ops, as the reference
computes it in jnp outside any kernel; it writes the new key/value into the
cache in place (the reference returns an updated copy), which keeps one
cache buffer per layer alive instead of two. Whisper's cross attention
(``cross_attention`` over the encoder memory's ``memory_kv``) takes the
flash kernel with ``causal=False`` at prefill, where the reference runs its
jnp ``sdpa``; a decode step's single query takes plain einsums.

``sdpa`` is the reference's jnp attention, differentiable: the training
path's attention (the flash kernel has no backward), dense or, with
``block_q``, streamed over query blocks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KERNELS, KernelSet
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init


class Attention(nn.Module):
    """Projection weights of one attention layer, reference leaf names."""

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wq = dense_init(d, cfg.n_heads * hd, **kw)
        self.wk = dense_init(d, cfg.n_kv_heads * hd, **kw)
        self.wv = dense_init(d, cfg.n_kv_heads * hd, **kw)
        self.wo = dense_init(cfg.n_heads * hd, d, **kw)
        if cfg.qkv_bias:
            zeros = lambda n: nn.Parameter(torch.zeros((n,), device=device,
                                                       dtype=dtype))
            self.bq = zeros(cfg.n_heads * hd)
            self.bk = zeros(cfg.n_kv_heads * hd)
            self.bv = zeros(cfg.n_kv_heads * hd)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _rope(cfg: ModelConfig, q, k, positions):
    """RoPE by positions (B, S), or M-RoPE by positions (3, B, S)."""
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None = None,
                q_offset: int = 0) -> torch.Tensor:
    """Dense-mask attention (materialises the (Sq, Sk) scores), port of
    ``src/repro/models/attention.py:62``: scores and softmax in float32,
    the probabilities cast to q's dtype before the second einsum."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, D)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: int | None = None, q_offset: int = 0,
         block_q: int | None = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA broadcast, port of
    ``src/repro/models/attention.py:86``. q (B,Sq,H,D); k/v (B,Sk,Hkv,D);
    ``q_offset`` is the position of q[0] relative to k[0]; ``window`` keeps
    keys in [pos - window + 1, pos].

    The reference's branches, kept: a window of at least Sk is no window;
    the dense form unless ``block_q`` is set, Sq > 2 block_q, block_q
    divides Sq and q_offset == 0. Otherwise queries go through a loop over
    blocks of ``block_q`` rows (the reference's ``lax.scan``): without a
    window each block sees every key (the causal mask inside); with one,
    the keys are padded in front by the window rounded up to a block and
    each block sees a static span of ``pad + block_q`` of them."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if window is not None and window >= Sk:
        window = None  # SWA window covers the whole sequence: plain causal
    if (block_q is None or Sq <= 2 * block_q or Sq % block_q
            or q_offset != 0):
        return _sdpa_dense(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)

    Hkv = k.shape[2]
    groups = H // Hkv
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    pad = 0
    if window is not None:
        pad = ((window - 1 + block_q - 1) // block_q) * block_q
        k = F.pad(k, (0, 0, 0, 0, pad, 0))
        v = F.pad(v, (0, 0, 0, 0, pad, 0))
    outs = []
    for iq in range(Sq // block_q):
        q0 = iq * block_q
        if window is not None:
            kb, vb = k[:, q0:q0 + pad + block_q], v[:, q0:q0 + pad + block_q]
            k_pos = q0 - pad + torch.arange(pad + block_q, device=q.device)
        else:
            kb, vb = k, v
            k_pos = torch.arange(Sk, device=q.device)
        qg = q[:, q0:q0 + block_q].reshape(B, block_q, Hkv, groups, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb).float() * scale
        q_pos = q0 + torch.arange(block_q, device=q.device)
        if window is not None:
            m = ((k_pos[None, :] >= 0) & (k_pos[None, :] <= q_pos[:, None])
                 & (k_pos[None, :] > q_pos[:, None] - window))
        elif causal:
            m = k_pos[None, :] <= q_pos[:, None]
        else:
            m = None
        if m is not None:
            s = s.masked_fill(~m, float("-inf"))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vb)
        outs.append(o.reshape(B, block_q, H, D))
    return torch.cat(outs, dim=1)


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, kernels: KernelSet = KERNELS
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full causal self-attention over x (training / prefill). Returns the
    output and the rotated keys and values, which prefill caches."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope(cfg, q, k, positions)
    out = kernels.flash_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p.wo, k, v


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache. For SWA layers the buffer is the window size and
    written round-robin; for full attention it is the max sequence length."""

    k: torch.Tensor  # (B, S_buf, Hkv, D)
    v: torch.Tensor  # (B, S_buf, Hkv, D)
    length: int  # tokens seen so far


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, *,
                  device: str | torch.device = "cuda") -> KVCache:
    dev = resolve_device(device)
    buf = max_seq if cfg.sliding_window is None else min(max_seq,
                                                         cfg.sliding_window)
    shape = (batch, buf, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=0)


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache, positions: torch.Tensor
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode step: x (B, 1, d_model) against the cache, at the
    absolute position ``positions`` (B, 1) int32 (every row the same, the
    host's ``cache.length``). The ring slot, the cache write and the mask
    are computed on the device from that tensor, so the step reads no host
    int and a CUDA graph of it replays at any position."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    rot = positions.expand(3, B, 1) if cfg.mrope else positions
    q, k = _rope(cfg, q, k, rot)

    buf = cache.k.shape[1]
    pos = positions[0]  # (1,)
    slot = torch.remainder(pos, buf).long()  # round-robin for SWA
    cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v.to(cache.v.dtype))

    # Validity: ring slots written so far, and (for SWA) within the window.
    # Slot i holds the largest position p <= pos with p % buf == i; the
    # Python-style modulo of a negative number (torch.remainder) is what
    # makes that formula right.
    k_idx = torch.arange(buf, device=x.device)
    if cfg.sliding_window is None:
        valid = k_idx <= pos
    else:
        k_pos = pos - torch.remainder(pos - k_idx, buf)
        valid = ((k_pos >= 0) & (k_pos > pos - cfg.sliding_window)
                 & (k_pos <= pos))

    out = _one_query(q, cache.k, cache.v, valid) @ p.wo
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def _one_query(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """One query (B, 1, H, D) over k/v (B, Sk, Hkv, D) by plain einsums
    with the softmax in f32, keys outside ``valid`` masked -> (B, 1, H*D).
    A decode step's single query takes this rather than the flash kernel,
    as the reference's decode does."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(q.dtype))
    scores = scores.float() / math.sqrt(D)
    if valid is not None:
        scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    return out.reshape(B, 1, H * D)


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    memory_kv: tuple[torch.Tensor, torch.Tensor],
                    kernels: KernelSet = KERNELS) -> torch.Tensor:
    """x (B, Sq, d) attends over the encoder's K/V (B, Sk, Hkv, D), no
    mask and no rotation; the biases are not applied, as in the
    reference. A prompt takes the flash kernel, a decode step (Sq = 1) the
    plain einsums of ``decode_attention``."""
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p.wq).reshape(B, Sq, cfg.n_heads, hd)
    k, v = memory_kv
    if Sq == 1:
        return _one_query(q, k, v) @ p.wo
    out = kernels.flash_attention(q, k, v, causal=False)
    return out.reshape(B, Sq, cfg.n_heads * hd) @ p.wo


def memory_kv(p: Attention, cfg: ModelConfig, memory: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory's K/V (B, Sk, Hkv, D), once per sequence."""
    B, Sk, _ = memory.shape
    hd = cfg.head_dim
    return ((memory @ p.wk).reshape(B, Sk, cfg.n_kv_heads, hd),
            (memory @ p.wv).reshape(B, Sk, cfg.n_kv_heads, hd))
