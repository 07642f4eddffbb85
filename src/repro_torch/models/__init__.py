"""Model zoo of the port: the dense GQA, Mamba-2 (SSM), MoE and hybrid
decoders, whisper's encoder-decoder and qwen2-vl's M-RoPE backbone."""

from repro_torch.models.attention import KVCache, init_kv_cache, sdpa
from repro_torch.models.layers import cross_entropy
from repro_torch.models.mamba2 import (
    Mamba2,
    SSMState,
    init_ssm_state,
    ssd_chunked,
)
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import (
    DecodeState,
    Encoder,
    Transformer,
    block_period,
    count_params,
    jax_tree_names,
    kernel_launches,
    layer_kinds,
    load_jax_params,
    loss_fn,
    param_bytes,
    train_paths,
)

__all__ = [k for k in dir() if not k.startswith("_")]
