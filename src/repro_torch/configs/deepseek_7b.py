"""deepseek-7b — llama-arch dense, arXiv:2401.02954.

30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008 vocab=102400,
head_dim 128, rope theta 1e4.
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="deepseek-7b",
    family=Family.DENSE,
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
    family=Family.DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=1e4,
)
