"""Meta-tensor stand-ins for every model input (dry run, no allocation),
port of ``src/repro/configs/specs.py``.

``param_specs`` / ``batch_specs`` / ``decode_specs`` give the shapes and
dtypes the launch step functions take, on ``device="meta"``: the
72B-parameter configs never materialise. The reference's
``jax.eval_shape`` becomes a ``Transformer`` built on meta tensors. The
port keeps one module per layer, so a parameter or cache has no leading
super-block axis, and a cache's ``length`` and the state's ``step`` are
Python ints. The stub modality frontends surface here as in the
reference: qwen2-vl's ``patch_embeds`` and whisper's ``encoder_frames``
are precomputed-embedding inputs.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import (
    Family,
    ModelConfig,
    ShapeConfig,
    ShapeKind,
    supports_long_context,
)


def max_positions_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Learned-position-table size needed by this cell (whisper extension)."""
    if not cfg.max_position_embeddings:
        return 0
    return max(cfg.max_position_embeddings, shape.seq_len)


def meta_model(cfg: ModelConfig, shape: ShapeConfig | None = None):
    """The ``Transformer`` of ``cfg`` on meta tensors, weights in
    ``cfg.dtype``, its position table sized for ``shape``."""
    from repro_torch.models import Transformer
    mp = max_positions_for(cfg, shape) if shape is not None else 0
    return Transformer(cfg, device="meta", dtype=getattr(torch, cfg.dtype),
                       max_positions=mp)


def param_specs(cfg: ModelConfig, shape: ShapeConfig | None = None
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{parameter name: (shape, dtype)} of the meta model, no allocation."""
    return {name: (tuple(p.shape), p.dtype)
            for name, p in meta_model(cfg, shape).named_parameters()}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training / prefill batch on meta tensors: tokens, labels and the
    stub-frontend inputs."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    if cfg.mrope:
        batch["positions"] = _meta((3, B, S), torch.int32)
    if cfg.family == Family.VLM and cfg.vision_patches:
        batch["patch_embeds"] = _meta(
            (B, min(cfg.vision_patches, S), cfg.d_model),
            getattr(torch, cfg.dtype))
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = _meta(
            (B, cfg.encoder_seq, cfg.d_model), getattr(torch, cfg.dtype))
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model=None):
    """(meta ``DecodeState``, meta (B, 1) int32 tokens) for one decode step.

    The state holds a KV cache of ``shape.seq_len`` tokens (or the SWA
    window / SSM state for sub-quadratic archs); whisper's cross K/V come
    from a meta pass of its encoder over meta frames. ``model``: the meta
    model to build it from (default ``meta_model(cfg, shape)``)."""
    from repro_torch.models import train_paths

    B, S = shape.global_batch, shape.seq_len
    model = model if model is not None else meta_model(cfg, shape)
    frames = (_meta((B, cfg.encoder_seq, cfg.d_model),
                    getattr(torch, cfg.dtype))
              if cfg.is_encoder_decoder else None)
    state = model.init_decode_state(B, S, encoder_frames=frames,
                                    kernels=train_paths(cfg))
    return state, _meta((B, 1), torch.int32)


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? Returns (ok, reason-if-not)."""
    if shape.kind == ShapeKind.LONG_DECODE and not supports_long_context(cfg):
        return False, ("full attention is O(L^2) at 524288 tokens; only "
                       "SSM/hybrid/SWA archs run long_500k (DESIGN.md §4)")
    return True, ""
