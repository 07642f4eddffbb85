"""The model zoo's decoder stack (port of
``src/repro/models/transformer.py``): the DENSE, SSM, MOE and HYBRID
families, whisper's encoder-decoder (AUDIO), qwen2-vl's M-RoPE backbone
(VLM), and the layer-pattern hybrids only the port holds
(``configs.pattern``: Nemotron-H's single-kind Mamba-2, MoE and attention
blocks).

``Transformer`` is an ``nn.Module`` whose parameters keep the reference's
leaf names and (d_in, d_out) orientation; the reference stacks each
sub-layer position over super-blocks for ``lax.scan``, the port keeps one
``DecoderLayer`` per layer in a ``ModuleList`` and ``load_jax_params``
unstacks (whisper's ``encoder.blocks`` likewise). Each layer follows its
``SubLayerKind``: an attention or Mamba-2 mixer, whisper's cross attention
over the encoder memory, then a dense SwiGLU (fc-GELU-fc when
``cfg.mlp_gelu``), an MoE or no FF; a pattern config's layer is one block
of one kind, a mixer without an FF or an MoE FF without a mixer, behind
one norm. Prefill attention, the encoder's and
the cross attention, the SSD scan, the expert FF and every RMSNorm go
through the CUDA kernels (their plain versions on CPU tensors); the expert
FF does in decode too, while a decode step's single query (self and cross
attention) takes plain einsums. ``prefill`` and ``decode_step`` also
take another kernel set, so that a check can hold them against the plain
versions on the card and the dry run can count their operations on meta
tensors; ``forward`` always uses the kernels. ``init_decode_state``
builds empty caches, on ``meta`` too.

Training (``forward_train``, ``loss_fn``) runs with autograd on through
``train_paths(cfg)``, the reference's ``use_pallas=False`` functions:
blocked ``sdpa``, ``ssd_chunked``, the einsum expert FF and the plain
RMSNorm. The kernels have no backward (nor have the reference's), and
their outputs carry no gradient, so no training call reaches them. Remat
applies per super-block of ``block_period(cfg)`` layers, as the
reference's ``lax.scan`` step (per layer for a pattern, which has no
period); its ``act_spec`` and ``scan_unroll`` are GSPMD and scan knobs
with no eager counterpart.

The stub frontends arrive as inputs, as in the reference: qwen2-vl's
``patch_embeds`` (B, P, d) replace the first P token embeddings, and
whisper's ``encoder_frames`` (B, S_enc, d) feed the encoder.

Quirks kept from the reference: ``prefill`` materialises the caches in
``cache_dtype``, bfloat16 by default whatever ``cfg.cache_dtype`` says,
and the ring buffer holds ``min(max_seq, window)`` positions; decode
positions continue from the prompt length (also under M-RoPE), and the
learned position table is read ``% its size``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import Family, ModelConfig
from repro_torch.configs.pattern import KINDS, option
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.ops import KERNELS, KernelSet
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    MLP,
    GeluMLP,
    RMSNorm,
    cross_entropy,
    dense_init,
    embed_init,
    sinusoid_pos,
)
from repro_torch.models.mamba2 import (
    Mamba2,
    SSMState,
    init_ssm_state,
    mamba_decode_step,
    mamba_forward,
    ssd_chunked,
)
from repro_torch.models.moe import MoE
from repro_torch.models.remat import wrap_remat


@dataclasses.dataclass(frozen=True)
class SubLayerKind:
    """Static structure of one sub-layer position within the super-block."""

    mixer: Optional[str]  # "attn" | "mamba" | None (a pattern's MoE block)
    ff: Optional[str]  # "dense" | "moe" | None (SSM family has no FF)
    cross_attn: bool = False  # whisper decoder

    @property
    def norm2(self) -> bool:
        """A second norm before the FF: a layer with a mixer and an FF."""
        return self.mixer is not None and self.ff is not None


def block_period(cfg: ModelConfig) -> int:
    """Layers of one super-block: 1 for a layer pattern (no period)."""
    if option(cfg, "layer_pattern"):
        return 1
    a = cfg.attn_period if cfg.attn_period > 0 else 1
    m = cfg.moe_period if cfg.n_experts else 1
    return math.lcm(a, m)


def layer_kinds(cfg: ModelConfig) -> list[SubLayerKind]:
    """The per-position kinds of one super-block (constant across supers);
    for a layer pattern, every layer's kind."""
    pattern = option(cfg, "layer_pattern")
    if pattern:
        return [SubLayerKind(*KINDS[c]) for c in pattern]
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


def kernel_launches(cfg: ModelConfig, decode_steps: int = 0) -> dict:
    """The kernel launches of one prefill of a prompt longer than one token
    and ``decode_steps`` decode steps: RMSNorm for every norm (each layer's
    norm1, the norm2 of a layer with a mixer and an FF, a cross layer's
    third, a Mamba layer's gated norm, the final; whisper's encoder's two a
    layer and its final, at prefill), flash for every prefill attention
    (the encoder's and the cross attention too), the SSD scan for each
    Mamba layer's prefill, three grouped matmuls (two for relu^2 experts)
    for each MoE layer in every pass."""
    kinds = layer_kinds(cfg)
    kinds = [kinds[i % len(kinds)] for i in range(cfg.n_layers)]
    n_attn = sum(k.mixer == "attn" for k in kinds)
    n_mamba = sum(k.mixer == "mamba" for k in kinds)
    n_norm2 = sum(k.norm2 for k in kinds)
    n_moe = sum(k.ff == "moe" for k in kinds)
    n_cross = sum(k.cross_attn for k in kinds)
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    passes = 1 + decode_steps
    gmm = 2 if option(cfg, "moe_act") == "relu2" else 3
    return {"flash_attention": n_attn + n_cross + n_enc,
            "ssd_scan": n_mamba,
            "grouped_matmul": gmm * n_moe * passes,
            "fused_rmsnorm": (len(kinds) + n_norm2 + n_cross + n_mamba + 1)
            * passes + (2 * n_enc + 1 if n_enc else 0)}


def _train_attention(q, k, v, *, causal: bool = True,
                     window: int | None = None, block_q: int | None = None):
    """The training path's attention slot: ``sdpa``, blocked by
    ``block_q`` for the causal self-attention only, as the reference
    passes ``cfg.attn_block_q`` there and not to the encoder's or the
    cross attention (both ``causal=False``)."""
    return attn_mod.sdpa(q, k, v, causal=causal, window=window,
                         block_q=block_q if causal else None)


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The training path's expert FF slot: the reference's einsum in the
    parameter dtype, on the (E, G*C, d) layout."""
    return torch.einsum("ecd,edf->ecf", x, w)


def train_paths(cfg: ModelConfig) -> KernelSet:
    """The reference's ``use_pallas=False`` functions, differentiable, in
    the kernel set's slots: blocked ``sdpa`` (``cfg.attn_block_q``),
    ``ssd_chunked``, the einsum expert FF and the jnp RMSNorm
    (``kernels.ref.rmsnorm_ref``, the same function)."""
    return KernelSet(
        flash_attention=functools.partial(_train_attention,
                                          block_q=cfg.attn_block_q),
        rmsnorm=ref.rmsnorm_ref, ssd_scan=ssd_chunked,
        grouped_matmul=_expert_matmul)


@dataclasses.dataclass
class DecodeState:
    """One cache per layer (a KVCache for attention, an SSMState for
    Mamba-2, None for a layer without a mixer), the count of tokens seen
    so far and each layer's cross-attention K/V of the encoder memory
    (filled once by ``prefill``; None for each layer of a decoder-only
    model)."""

    caches: list[Optional[Union[KVCache, SSMState]]]
    step: int
    cross_kv: list[Optional[tuple[torch.Tensor, torch.Tensor]]]


def _ff(cfg: ModelConfig, **kw) -> nn.Module:
    return (GeluMLP if cfg.mlp_gelu else MLP)(cfg.d_model, cfg.d_ff, **kw)


class DecoderLayer(nn.Module):
    """One pre-norm layer of the given kind: ``norm1`` + an ``attn`` or
    ``mamba`` mixer, then (whisper) ``norm_x`` + ``cross`` attention over
    the encoder memory, then ``norm2`` + an ``ff`` (SwiGLU, or fc-GELU-fc
    when ``cfg.mlp_gelu``) or ``moe`` FF, or no FF (the SSM family). A
    layer without a mixer (a pattern's MoE block) is ``norm1`` + ``moe``."""

    def __init__(self, cfg: ModelConfig, kind: SubLayerKind, *, device,
                 dtype: torch.dtype, generator: torch.Generator | None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if kind.mixer == "attn":
            self.attn = attn_mod.Attention(cfg, **kw)
        elif kind.mixer == "mamba":
            self.mamba = Mamba2(cfg, **kw)
        if kind.cross_attn:
            self.norm_x = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
            self.cross = attn_mod.Attention(cfg, **kw)
        if kind.norm2:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if kind.ff == "dense":
            self.ff = _ff(cfg, **kw)
        elif kind.ff == "moe":
            self.moe = MoE(cfg, **kw)
        self.cfg = cfg

    def cross_attend(self, x: torch.Tensor, mkv,
                     kernels: KernelSet = KERNELS) -> torch.Tensor:
        """x + cross attention of norm_x(x) over the encoder K/V ``mkv``
        (x itself when the layer has none)."""
        if not self.kind.cross_attn:
            return x
        h = self.norm_x(x, kernels)
        return x + attn_mod.cross_attention(self.cross, self.cfg, h, mkv,
                                            kernels)

    def feed_forward(self, x: torch.Tensor, kernels: KernelSet = KERNELS
                     ) -> tuple[torch.Tensor, torch.Tensor | float]:
        """(x + the layer's FF of norm2(x), the MoE aux loss); x itself and
        0 when it has none. A layer without a mixer normalises by norm1."""
        norm = self.norm2 if self.kind.norm2 else self.norm1
        if self.kind.ff == "dense":
            return x + self.ff(norm(x, kernels)), 0.0
        if self.kind.ff == "moe":
            y, aux = self.moe(norm(x, kernels), kernels)
            return x + y, aux
        return x, 0.0

    def forward(self, x: torch.Tensor, positions: torch.Tensor, mkv,
                kernels: KernelSet = KERNELS
                ) -> tuple[torch.Tensor, torch.Tensor | float]:
        """One pre-norm layer over the whole sequence: (x, MoE aux)."""
        if self.kind.mixer is not None:
            h = self.norm1(x, kernels)
            if self.kind.mixer == "attn":
                y, _, _ = attn_mod.attention(self.attn, self.cfg, h,
                                             positions, kernels)
            else:
                y, _ = mamba_forward(self.mamba, self.cfg, h,
                                     kernels=kernels)
            x = x + y
        return self.feed_forward(self.cross_attend(x, mkv, kernels), kernels)


def _feed_forward(layer: DecoderLayer, x: torch.Tensor,
                  kernels: KernelSet) -> torch.Tensor:
    """A served layer's FF inside its span, ``moe`` or ``ff`` (none for
    a layer without an FF)."""
    if layer.kind.ff is None:
        return x
    with obs.span("moe" if layer.kind.ff == "moe" else "ff"):
        return layer.feed_forward(x, kernels)[0]


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


class EncoderLayer(nn.Module):
    """One pre-norm layer of whisper's encoder: ``norm1`` + bidirectional
    self-attention ``attn`` (no rotation), ``norm2`` + ``ff``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype: torch.dtype,
                 generator: torch.Generator | None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = attn_mod.Attention(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.ff = _ff(cfg, **kw)


class Encoder(nn.Module):
    """Whisper's encoder over the stub frontend's frames (B, S_enc, d): the
    sinusoid table added to the frames, ``cfg.n_encoder_layers`` pre-norm
    layers whose self-attention takes the flash kernel with
    ``causal=False``, then ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype: torch.dtype,
                 generator: torch.Generator | None):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            EncoderLayer(cfg, device=device, dtype=dtype, generator=generator)
            for _ in range(cfg.n_encoder_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        # built once: a row does not depend on the table's length
        self.register_buffer("pos_table", sinusoid_pos(
            cfg.encoder_seq, cfg.d_model, device=device), persistent=False)

    def forward(self, frames: torch.Tensor,
                kernels: KernelSet = KERNELS) -> torch.Tensor:
        """frames (B, S, d) with S <= ``cfg.encoder_seq``."""
        cfg = self.cfg
        B, S, _ = frames.shape
        x = frames + self.pos_table[:S].to(frames.dtype)
        for layer in self.blocks:
            h = layer.norm1(x, kernels)
            q, k, v = attn_mod._project_qkv(layer.attn, cfg, h)
            y = kernels.flash_attention(q, k, v, causal=False)
            x = x + y.reshape(B, S, -1) @ layer.attn.wo
            x = x + layer.ff(layer.norm2(x, kernels))
        return self.final_norm(x, kernels)


class Transformer(nn.Module):
    """Every family of the zoo: DENSE (``h2o-danube-1.8b`` and the other
    dense configs), SSM (``mamba2-780m``), MOE (``qwen3-moe-30b-a3b``),
    HYBRID (``jamba-v0.1-52b``), AUDIO (``whisper-base``, with its
    ``encoder`` and learned ``pos_embed``) and VLM (``qwen2-vl-7b``).
    ``dtype`` is the weights' dtype (norm scales, the router and the SSM's
    A/D/dt-bias stay float32). ``max_positions`` sizes the decoder's
    position table (0: ``cfg.max_position_embeddings``), as
    ``init_params(max_positions=)`` does."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 max_positions: int = 0):
        super().__init__()
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
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, **kw)
            self.pos_embed = embed_init(
                max_positions or cfg.max_position_embeddings, cfg.d_model,
                **kw)

    @classmethod
    def from_params(cls, cfg: ModelConfig, params: dict, *,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32,
                    max_positions: int = 0) -> "Transformer":
        """The model of ``cfg`` holding ``params`` ({name: tensor}, every
        parameter), built on meta tensors and then filled, so no weight is
        drawn first."""
        dev = resolve_device(device)
        model = cls(cfg, device="meta", dtype=dtype,
                    max_positions=max_positions).to_empty(device=dev)
        if cfg.is_encoder_decoder:  # the one buffer, not a parameter
            model.encoder.pos_table = sinusoid_pos(
                cfg.encoder_seq, cfg.d_model, device=dev)
        missing = {n for n, _ in model.named_parameters()} - set(params)
        if missing:
            raise ValueError(f"no tensor for parameters {sorted(missing)}")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.as_tensor(params[name]))
        return model

    def _logits(self, x: torch.Tensor,
                kernels: KernelSet = KERNELS) -> torch.Tensor:
        x = self.final_norm(x, kernels)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    def _embed(self, tokens: torch.Tensor,
               patch_embeds: torch.Tensor | None = None,
               positions: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings, the patches spliced over the first P, plus the
        learned position table at ``positions`` (B, S) (default arange)
        read % its size."""
        x = F.embedding(tokens, self.embed)
        if patch_embeds is not None:
            P = patch_embeds.shape[1]
            x = torch.cat([patch_embeds.to(x.dtype), x[:, P:]], dim=1)
        if self.cfg.is_encoder_decoder:
            n_pos = self.pos_embed.shape[0]
            pos = (torch.arange(tokens.shape[1], device=tokens.device)
                   if positions is None else positions.long())
            x = x + self.pos_embed[pos % n_pos]
        return x

    def _positions(self, tokens: torch.Tensor,
                   positions: torch.Tensor | None) -> torch.Tensor:
        """The given rotary positions, else arange (B, S), broadcast to
        (3, B, S) under M-RoPE."""
        if positions is not None:
            return positions
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        return pos.expand(3, B, S) if self.cfg.mrope else pos

    def _memory_kv(self, encoder_frames: torch.Tensor | None,
                   kernels: KernelSet) -> list:
        """Each layer's cross-attention K/V of the encoded frames (None
        for each layer of a decoder-only model)."""
        if not self.cfg.is_encoder_decoder:
            return [None] * len(self.layers)
        if encoder_frames is None:
            raise ValueError(f"{self.cfg.name} needs encoder_frames")
        memory = self.encoder(encoder_frames, kernels)
        return [attn_mod.memory_kv(layer.cross, self.cfg, memory)
                for layer in self.layers]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                patch_embeds: torch.Tensor | None = None,
                encoder_frames: torch.Tensor | None = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) through the kernels.
        ``positions``: rotary positions (B, S), or (3, B, S) under M-RoPE
        (default arange); ``patch_embeds`` (B, P, d); ``encoder_frames``
        (B, S_enc, d)."""
        logits, _ = self.forward_train(
            tokens, positions=positions, patch_embeds=patch_embeds,
            encoder_frames=encoder_frames, kernels=KERNELS)
        return logits

    def forward_train(self, tokens: torch.Tensor, *,
                      positions: torch.Tensor | None = None,
                      patch_embeds: torch.Tensor | None = None,
                      encoder_frames: torch.Tensor | None = None,
                      remat: str = "none",
                      kernels: KernelSet | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward with autograd on, port of the reference's
        ``forward``: (logits (B, S, V), the summed MoE aux loss). The
        layers run in super-blocks of ``block_period(cfg)``, each wrapped
        by the ``remat`` policy (``repro_torch.models.remat``); ``kernels``
        defaults to ``train_paths(cfg)``."""
        cfg = self.cfg
        kernels = kernels or train_paths(cfg)
        positions = self._positions(tokens, positions)
        x = self._embed(tokens, patch_embeds=patch_embeds)
        memory = None
        if cfg.is_encoder_decoder:
            if encoder_frames is None:
                raise ValueError(f"{cfg.name} needs encoder_frames")
            memory = self.encoder(encoder_frames, kernels)
        period = block_period(cfg)

        def superblock(x, memory, first):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for layer in self.layers[first:first + period]:
                mkv = (None if memory is None
                       else attn_mod.memory_kv(layer.cross, cfg, memory))
                x, a = layer(x, positions, mkv, kernels)
                aux = aux + a
            return x, aux

        superblock = wrap_remat(superblock, remat)
        auxes = []
        for first in range(0, len(self.layers), period):
            x, aux = superblock(x, memory, first)
            auxes.append(aux)
        return self._logits(x, kernels), torch.stack(auxes).sum()

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: int,
                positions: torch.Tensor | None = None,
                patch_embeds: torch.Tensor | None = None,
                encoder_frames: torch.Tensor | None = None,
                cache_dtype: torch.dtype = torch.bfloat16,
                kernels: KernelSet = KERNELS
                ) -> tuple[torch.Tensor, DecodeState]:
        """Full-sequence forward that also materialises the decode caches
        (and, for an encoder-decoder, the cross K/V). Returns (logits
        (B, S, V), DecodeState ready for token S)."""
        cfg = self.cfg
        S = tokens.shape[1]
        positions = self._positions(tokens, positions)
        kv_buf = (max_seq if cfg.sliding_window is None
                  else min(max_seq, cfg.sliding_window))
        x = self._embed(tokens, patch_embeds=patch_embeds)
        cross_kv = self._memory_kv(encoder_frames, kernels)
        caches = []
        for layer, mkv in zip(self.layers, cross_kv):
            cache = None
            if layer.kind.mixer is not None:
                with obs.span(layer.kind.mixer):
                    h = layer.norm1(x, kernels)
                    if layer.kind.mixer == "attn":
                        y, k, v = attn_mod.attention(layer.attn, cfg, h,
                                                     positions, kernels)
                        cache = KVCache(
                            k=_kv_to_ring(k.to(cache_dtype), kv_buf),
                            v=_kv_to_ring(v.to(cache_dtype), kv_buf),
                            length=S)
                    else:
                        y, cache = mamba_forward(layer.mamba, cfg, h,
                                                 kernels=kernels)
                x = x + y
            caches.append(cache)
            x = _feed_forward(layer, layer.cross_attend(x, mkv, kernels),
                              kernels)
        with obs.span("head"):
            logits = self._logits(x, kernels)
        return logits, DecodeState(caches=caches, step=S, cross_kv=cross_kv)

    @torch.no_grad()
    def decode_step(self, state: DecodeState, tokens: torch.Tensor, *,
                    positions: torch.Tensor | None = None,
                    kernels: KernelSet = KERNELS
                    ) -> tuple[torch.Tensor, DecodeState]:
        """One-token decode. tokens (B, 1) -> (logits (B, 1, V), new state).
        KV caches are updated in place (see ``decode_attention``); SSM
        states are replaced; the cross K/V carry over. ``positions``: the
        new token's position (B, 1) int32 on the device, ``state.step`` in
        every row (built here by default: a launch, not a host wait); the
        rotary angles, the ring slot and mask and the learned position
        table all read it. ``kernels``: the norms' and the expert FF's
        functions (the dry run counts a step through ``train_paths(cfg)``)."""
        if positions is None:
            positions = torch.full((tokens.shape[0], 1), state.step,
                                   dtype=torch.int32, device=tokens.device)
        x = self._embed(tokens, positions=positions)
        cross_kv = state.cross_kv
        caches = []
        for layer, cache, mkv in zip(self.layers, state.caches, cross_kv):
            if layer.kind.mixer is not None:
                with obs.span(layer.kind.mixer):
                    h = layer.norm1(x, kernels)
                    if layer.kind.mixer == "attn":
                        y, cache = attn_mod.decode_attention(
                            layer.attn, self.cfg, h, cache, positions)
                    else:
                        y, cache = mamba_decode_step(layer.mamba, self.cfg,
                                                     h, cache, kernels)
                x = x + y
            caches.append(cache)
            x = _feed_forward(layer, layer.cross_attend(x, mkv, kernels),
                              kernels)
        with obs.span("head"):
            logits = self._logits(x, kernels)
        return logits, DecodeState(caches=caches, step=state.step + 1,
                                   cross_kv=cross_kv)

    @torch.no_grad()
    def init_decode_state(self, batch: int, max_seq: int, *,
                          encoder_frames: torch.Tensor | None = None,
                          cache_dtype: torch.dtype | None = None,
                          kernels: KernelSet = KERNELS) -> DecodeState:
        """Empty decode caches for ``batch`` sequences of up to ``max_seq``
        tokens, port of the reference's ``init_decode_state``: a KV cache
        in ``cache_dtype`` (default ``cfg.cache_dtype``) for each attention
        layer, a zero SSM state for each Mamba layer, None for a layer
        without a mixer, and, for an encoder-decoder, each layer's cross
        K/V of the encoded ``encoder_frames``. Built on the model's device,
        ``meta`` too."""
        cfg = self.cfg
        dev = self.embed.device
        dtype = cache_dtype or getattr(torch, cfg.cache_dtype)
        caches = [attn_mod.init_kv_cache(cfg, batch, max_seq, dtype,
                                         device=dev)
                  if layer.kind.mixer == "attn"
                  else init_ssm_state(cfg, batch, device=dev)
                  if layer.kind.mixer == "mamba" else None
                  for layer in self.layers]
        return DecodeState(caches=caches, step=0,
                           cross_kv=self._memory_kv(encoder_frames, kernels))


def loss_fn(model: Transformer, batch: dict, *, remat: str = "none",
            aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Next-token CE + ``aux_weight`` x the MoE aux loss, port of the
    reference's ``loss_fn``. ``batch``: ``tokens``/``labels`` (B, S), and
    optionally ``positions``, ``patch_embeds``, ``encoder_frames``,
    ``mask``. Returns (loss, {"loss", "ce", "moe_aux"})."""
    logits, aux = model.forward_train(
        batch["tokens"], positions=batch.get("positions"),
        patch_embeds=batch.get("patch_embeds"),
        encoder_frames=batch.get("encoder_frames"), remat=remat)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + aux_weight * aux
    return loss, {"loss": loss, "ce": ce, "moe_aux": aux}


def count_params(params) -> int:
    """Elements of a module's parameters or of a dict of tensors."""
    leaves = params.values() if isinstance(params, dict) else \
        params.parameters()
    return sum(p.numel() for p in leaves)


def param_bytes(params) -> int:
    leaves = params.values() if isinstance(params, dict) else \
        params.parameters()
    return sum(p.numel() * p.element_size() for p in leaves)


def jax_tree_names(cfg: ModelConfig, tree: dict) -> dict:
    """A tree shaped like the reference's ``init_params`` (its params, or
    their gradients or AdamW moments) as {port parameter name: leaf}.

    A name map plus unstacking: ``tree["blocks"][j]`` holds sub-layer
    position j of every super-block stacked on a leading axis, so its
    entry s is layer ``s * period + j``; whisper's
    ``tree["encoder"]["blocks"]`` stacks the encoder layers, entry s being
    ``encoder.blocks.s``."""
    period = block_period(cfg)
    out: dict = {}

    def leaves(sub: dict, prefix: str = ""):
        for key, val in sub.items():
            if isinstance(val, dict):
                yield from leaves(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", val

    def unstack(sub: dict, name_of) -> None:
        for name, stacked in leaves(sub):
            for s in range(np.shape(stacked)[0]):
                out[name_of(s, name)] = stacked[s]

    encoder = dict(tree.get("encoder", {}))
    out.update(leaves({k: v for k, v in tree.items()
                       if k not in ("blocks", "encoder")}))
    for j, block in enumerate(tree["blocks"]):
        unstack(block, lambda s, name: f"layers.{s * period + j}.{name}")
    if "blocks" in encoder:
        unstack(encoder.pop("blocks"),
                lambda s, name: f"encoder.blocks.{s}.{name}")
    out.update(leaves(encoder, "encoder."))
    return out


def load_jax_params(model: Transformer, params: dict) -> Transformer:
    """Copy a reference ``init_params`` tree (leaves already numpy, e.g.
    ``jax.tree.map(np.asarray, params)``) into ``model``, by
    ``jax_tree_names``. Raises if a leaf has no parameter, a parameter
    gets no leaf, or a shape differs.
    """
    assigned: set[str] = set()
    for name, leaf in jax_tree_names(model.cfg, params).items():
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
    missing = {n for n, _ in model.named_parameters()} - assigned
    if missing:
        raise ValueError(f"parameters without a reference leaf: {sorted(missing)}")
    return model
