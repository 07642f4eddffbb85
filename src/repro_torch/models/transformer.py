"""Decoder stack of the DENSE, SSM and MOE families (port of
``src/repro/models/transformer.py``).

``Transformer`` is an ``nn.Module`` whose parameters keep the reference's
leaf names and (d_in, d_out) orientation; the reference stacks each
sub-layer position over super-blocks for ``lax.scan``, the port keeps one
``DecoderLayer`` per layer in a ``ModuleList`` and ``load_jax_params``
unstacks. Each layer follows its ``SubLayerKind``: an attention or Mamba-2
mixer, then a dense SwiGLU (fc-GELU-fc when ``cfg.mlp_gelu``), an MoE or
no FF. Prefill attention, the SSD scan, the expert FF and every RMSNorm go
through the CUDA kernels (their plain versions on CPU tensors); the expert
FF does in decode too. Only ``prefill`` takes another kernel set, so that
a check can hold it against the plain versions on the card; ``forward``
and ``decode_step`` always use the kernels. HYBRID (jamba), encoder-decoder (whisper) and M-RoPE
(qwen2-vl) models are not ported yet.

Quirks kept from the reference: ``prefill`` materialises the caches in
``cache_dtype``, bfloat16 by default whatever ``cfg.cache_dtype`` says,
and the ring buffer holds ``min(max_seq, window)`` positions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KERNELS, KernelSet
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    MLP,
    GeluMLP,
    RMSNorm,
    dense_init,
    embed_init,
)
from repro_torch.models.mamba2 import (
    Mamba2,
    SSMState,
    mamba_decode_step,
    mamba_forward,
)
from repro_torch.models.moe import MoE

_FAMILIES = (Family.DENSE, Family.SSM, Family.MOE)


@dataclasses.dataclass(frozen=True)
class SubLayerKind:
    """Static structure of one sub-layer position within the super-block."""

    mixer: str  # "attn" | "mamba"
    ff: Optional[str]  # "dense" | "moe" | None (SSM family has no FF)
    cross_attn: bool = False  # whisper decoder


def block_period(cfg: ModelConfig) -> int:
    a = cfg.attn_period if cfg.attn_period > 0 else 1
    m = cfg.moe_period if cfg.n_experts else 1
    return math.lcm(a, m)


def layer_kinds(cfg: ModelConfig) -> list[SubLayerKind]:
    """The per-position kinds of one super-block (constant across supers)."""
    period = block_period(cfg)
    if cfg.n_layers % period != 0:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible "
                         f"by layer pattern period={period}")
    kinds = []
    for j in range(period):
        mixer = "attn" if cfg.is_attn_layer(j) else "mamba"
        if cfg.family == Family.SSM:
            ff = None
        elif cfg.is_moe_layer(j):
            ff = "moe"
        else:
            ff = "dense"
        kinds.append(SubLayerKind(mixer=mixer, ff=ff,
                                  cross_attn=cfg.is_encoder_decoder))
    return kinds


@dataclasses.dataclass
class DecodeState:
    """One cache per layer (a KVCache for attention, an SSMState for
    Mamba-2), and the count of tokens seen so far."""

    caches: list[Union[KVCache, SSMState]]
    step: int


class DecoderLayer(nn.Module):
    """One pre-norm layer of the given kind: ``norm1`` + an ``attn`` or
    ``mamba`` mixer, then ``norm2`` + an ``ff`` (SwiGLU, or fc-GELU-fc when
    ``cfg.mlp_gelu``) or ``moe`` FF, or no FF (the SSM family)."""

    def __init__(self, cfg: ModelConfig, kind: SubLayerKind, *, device,
                 dtype: torch.dtype, generator: torch.Generator | None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if kind.mixer == "attn":
            self.attn = attn_mod.Attention(cfg, **kw)
        else:
            self.mamba = Mamba2(cfg, **kw)
        if kind.ff is not None:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if kind.ff == "dense":
            mlp_cls = GeluMLP if cfg.mlp_gelu else MLP
            self.ff = mlp_cls(cfg.d_model, cfg.d_ff, **kw)
        elif kind.ff == "moe":
            self.moe = MoE(cfg, **kw)

    def feed_forward(self, x: torch.Tensor,
                     kernels: KernelSet = KERNELS) -> torch.Tensor:
        """x + the layer's FF of norm2(x) (x itself when it has none)."""
        if self.kind.ff == "dense":
            return x + self.ff(self.norm2(x, kernels))
        if self.kind.ff == "moe":
            y, _ = self.moe(self.norm2(x, kernels), kernels)
            return x + y
        return x


def _kv_to_ring(k: torch.Tensor, buf: int) -> torch.Tensor:
    """Pack the last ``buf`` positions of k (B,S,H,D) into the ring layout
    of ``decode_attention``: slot i holds the largest p <= S-1 with
    p % buf == i."""
    S = k.shape[1]
    if S <= buf:
        return F.pad(k, (0, 0, 0, 0, 0, buf - S))
    start = S - buf
    src = start + torch.remainder(torch.arange(buf, device=k.device) - start,
                                  buf)
    return k[:, src]


class Transformer(nn.Module):
    """The decoder of the DENSE (``h2o-danube-1.8b`` and the other configs
    without M-RoPE), SSM (``mamba2-780m``) and MOE (``qwen3-moe-30b-a3b``)
    families. ``dtype`` is the weights' dtype (norm scales, the router and
    the SSM's A/D/dt-bias stay float32)."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if (cfg.family not in _FAMILIES or cfg.is_encoder_decoder
                or cfg.mrope):
            raise NotImplementedError(
                f"{cfg.name}: only the DENSE, SSM and MOE families are "
                "ported so far")
        kinds = layer_kinds(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.embed = embed_init(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kinds[i % len(kinds)], **kw)
            for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(cfg.d_model, cfg.vocab_size, **kw)

    def _logits(self, x: torch.Tensor,
                kernels: KernelSet = KERNELS) -> torch.Tensor:
        x = self.final_norm(x, kernels)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    @staticmethod
    def _positions(tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V)."""
        positions = self._positions(tokens)
        x = F.embedding(tokens, self.embed)
        for layer in self.layers:
            h = layer.norm1(x)
            if layer.kind.mixer == "attn":
                y, _, _ = attn_mod.attention(layer.attn, self.cfg, h, positions)
            else:
                y, _ = mamba_forward(layer.mamba, self.cfg, h)
            x = layer.feed_forward(x + y)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: int,
                cache_dtype: torch.dtype = torch.bfloat16,
                kernels: KernelSet = KERNELS
                ) -> tuple[torch.Tensor, DecodeState]:
        """Full-sequence forward that also materialises the decode caches.
        Returns (logits (B, S, V), DecodeState ready for token S)."""
        cfg = self.cfg
        S = tokens.shape[1]
        positions = self._positions(tokens)
        kv_buf = (max_seq if cfg.sliding_window is None
                  else min(max_seq, cfg.sliding_window))
        x = F.embedding(tokens, self.embed)
        caches = []
        for layer in self.layers:
            h = layer.norm1(x, kernels)
            if layer.kind.mixer == "attn":
                y, k, v = attn_mod.attention(layer.attn, cfg, h, positions,
                                             kernels)
                caches.append(KVCache(
                    k=_kv_to_ring(k.to(cache_dtype), kv_buf),
                    v=_kv_to_ring(v.to(cache_dtype), kv_buf), length=S))
            else:
                y, st = mamba_forward(layer.mamba, cfg, h, kernels=kernels)
                caches.append(st)
            x = layer.feed_forward(x + y, kernels)
        return self._logits(x, kernels), DecodeState(caches=caches, step=S)

    @torch.no_grad()
    def decode_step(self, state: DecodeState, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, DecodeState]:
        """One-token decode. tokens (B, 1) -> (logits (B, 1, V), new state).
        KV caches are updated in place (see ``decode_attention``); SSM
        states are replaced."""
        x = F.embedding(tokens, self.embed)
        caches = []
        for layer, cache in zip(self.layers, state.caches):
            h = layer.norm1(x)
            if layer.kind.mixer == "attn":
                y, cache = attn_mod.decode_attention(layer.attn, self.cfg, h,
                                                     cache)
            else:
                y, cache = mamba_decode_step(layer.mamba, self.cfg, h, cache)
            caches.append(cache)
            x = layer.feed_forward(x + y)
        return self._logits(x), DecodeState(caches=caches, step=state.step + 1)


def load_jax_params(model: Transformer, params: dict) -> Transformer:
    """Copy a reference ``init_params`` tree (leaves already numpy, e.g.
    ``jax.tree.map(np.asarray, params)``) into ``model``.

    A name map plus unstacking: ``params["blocks"][j]`` holds sub-layer
    position j of every super-block stacked on a leading axis, so its entry
    s is layer ``s * period + j``. Raises if a leaf has no parameter, a
    parameter gets no leaf, or a shape differs.
    """
    period = block_period(model.cfg)
    assigned: set[str] = set()

    def put(name: str, leaf) -> None:
        try:
            p = model.get_parameter(name)
        except AttributeError:
            raise KeyError(f"reference leaf {name!r} has no parameter") from None
        # through float32: numpy has no bfloat16 torch takes, and
        # bfloat16 -> float32 -> bfloat16 is exact
        t = torch.tensor(np.asarray(leaf, np.float32))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(t.to(p.dtype))
        assigned.add(name)

    def leaves(tree: dict, prefix: str = ""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", val

    for name, leaf in leaves({k: v for k, v in params.items()
                              if k != "blocks"}):
        put(name, leaf)
    for j, block in enumerate(params["blocks"]):
        for name, stacked in leaves(block):
            for s in range(np.shape(stacked)[0]):
                put(f"layers.{s * period + j}.{name}", stacked[s])
    missing = {n for n, _ in model.named_parameters()} - assigned
    if missing:
        raise ValueError(f"parameters without a reference leaf: {sorted(missing)}")
    return model
