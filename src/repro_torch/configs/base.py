"""Model + shape configuration system.

One ``ModelConfig`` describes any architecture in the zoo (dense / MoE / SSM /
hybrid / enc-dec / VLM-backbone). One ``ShapeConfig`` describes an input-shape
cell (train / prefill / decode / long-context-decode). The registry in
``repro_torch.configs`` maps ``--arch`` ids to full configs and provides the
reduced smoke variants used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Family(str, enum.Enum):
    DENSE = "dense"
    SSM = "ssm"
    MOE = "moe"
    HYBRID = "hybrid"
    AUDIO = "audio"  # encoder-decoder, conv frontend stubbed
    VLM = "vlm"  # decoder backbone, vision frontend stubbed


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact published dims in configs/<id>.py)."""

    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- attention ---
    rope_theta: float = 1e4
    qkv_bias: bool = False  # qwen2
    #: q-block size for the memory-bounded XLA attention path (None = dense)
    attn_block_q: int = 1024
    #: KV-cache dtype ("bfloat16" | "float8_e4m3fn"): fp8 halves decode's
    #: dominant HBM term and cache footprint (§Perf iteration on decode_32k)
    cache_dtype: str = "bfloat16"
    sliding_window: Optional[int] = None  # SWA (h2o-danube / mistral-style)
    mrope: bool = False  # qwen2-vl multimodal 3D RoPE
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w halves of head_dim/2

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0  # N: state size per head
    ssm_head_dim: int = 64  # P: channels per SSM head
    ssm_expand: int = 2  # d_inner = expand * d_model
    ssm_conv: int = 4  # depthwise conv width
    ssm_chunk: int = 128  # SSD chunk length
    #: hybrid interleave: attention at layers where i % period == offset
    #: (jamba: period 8, offset 4 -> 1:7 attn:mamba); 0 = no attention layers
    #: for SSM family / all layers attention otherwise.
    attn_period: int = 0
    attn_offset: int = 0

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden dim (falls back to d_ff)
    #: MoE at layers where i % moe_period == moe_offset (jamba: every 2nd)
    moe_period: int = 1
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    #: GShard-style dispatch group size (tokens); dispatch memory ~ Sg * E * C
    moe_group_size: int = 1024

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # frontend-stub output frames (whisper-base: 1500)

    # --- VLM (qwen2-vl) ---
    vision_patches: int = 0  # frontend-stub output patches per sequence

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    #: max positions for learned/absolute embeddings (0 = rotary only)
    max_position_embeddings: int = 0
    #: classic fc1-gelu-fc2 MLP (whisper) instead of SwiGLU
    mlp_gelu: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # --- derived quantities -----------------------------------------------------

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def is_attn_layer(self, i: int) -> bool:
        if self.family == Family.SSM:
            return False
        if self.attn_period <= 0:
            return True
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return i % self.moe_period == self.moe_offset

    def param_count(self) -> int:
        """Total parameters (analytic; validated against pytree size in tests)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        total += d  # final norm
        enc_layers = self.n_encoder_layers if self.is_encoder_decoder else 0
        for i in range(self.n_layers):
            total += self._layer_params(i)
        for _ in range(enc_layers):
            total += self._attn_params() + self._dense_ff_params() + 2 * d
        if self.is_encoder_decoder:
            total += d  # encoder final norm
            # decoder cross-attention (+ its norm) per layer
            total += self.n_layers * (self._attn_params() + self.d_model)
        if self.max_position_embeddings:
            # learned decoder position table (encoder uses sinusoids)
            total += self.max_position_embeddings * d
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _dense_ff_params(self) -> int:
        if self.mlp_gelu:  # fc1 + b1 + fc2 + b2
            return 2 * self.d_model * self.d_ff + self.d_ff + self.d_model
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate+up+down

    def _moe_ff_params(self) -> int:
        e = self.n_experts
        return self.d_model * e + e * 3 * self.d_model * self.expert_ff

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        conv_ch = di + 2 * n  # x + B + C streams share the conv
        in_proj = d * (2 * di + 2 * n + h)
        return (in_proj + conv_ch * (self.ssm_conv + 1)  # conv_w + conv_b
                + 3 * h  # A_log, D, dt_bias
                + di  # gated norm
                + di * d)  # out_proj

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        total = d  # norm1
        if self.is_attn_layer(i):
            total += self._attn_params()
        else:
            total += self._ssm_params()
        if self.family == Family.SSM:
            return total  # mamba2 block only, no FF
        total += d  # norm2
        if self.is_moe_layer(i):
            total += self._moe_ff_params()
        else:
            total += self._dense_ff_params()
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                dense_equiv = (self.experts_per_token * 3 * self.d_model
                               * self.expert_ff + self.d_model * self.n_experts)
                total -= self._moe_ff_params() - dense_equiv
        return total


class ShapeKind(str, enum.Enum):
    TRAIN = "train"
    PREFILL = "prefill"
    DECODE = "decode"
    LONG_DECODE = "long_decode"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: ShapeKind
    seq_len: int
    global_batch: int

    @property
    def lowers_serve_step(self) -> bool:
        return self.kind in (ShapeKind.DECODE, ShapeKind.LONG_DECODE)


#: The four assigned LM shapes (identical for every arch in the pool).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", ShapeKind.TRAIN, 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", ShapeKind.PREFILL, 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", ShapeKind.DECODE, 32768, 128),
    "long_500k": ShapeConfig("long_500k", ShapeKind.LONG_DECODE, 524288, 1),
}


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k needs sub-quadratic attention: SSM, hybrid, or SWA.

    Pure full-attention archs skip the cell (noted in DESIGN.md §4).
    """
    if cfg.family in (Family.SSM, Family.HYBRID):
        return True
    return cfg.sliding_window is not None


def supports_decode(cfg: ModelConfig) -> bool:
    """Encoder-only archs have no decode step (all assigned archs decode)."""
    return True
