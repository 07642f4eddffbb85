"""qwen2-72b — dense GQA with QKV bias, arXiv:2407.10671.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, head_dim 128,
rope theta 1e6, QKV bias.
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="qwen2-72b",
    family=Family.DENSE,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke",
    family=Family.DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=1e6,
    qkv_bias=True,
)
