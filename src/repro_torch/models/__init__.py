"""Model zoo of the port: the dense GQA decoder so far."""

from repro_torch.models.attention import KVCache, init_kv_cache
from repro_torch.models.transformer import (
    DecodeState,
    Transformer,
    block_period,
    layer_kinds,
    load_jax_params,
)

__all__ = [k for k in dir() if not k.startswith("_")]
