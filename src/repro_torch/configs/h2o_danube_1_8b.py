"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention,
arXiv:2401.16818.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, head_dim 80,
mistral-style sliding window (4096).
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b",
    family=Family.DENSE,
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    rope_theta=1e4,
    sliding_window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke",
    family=Family.DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=1e4,
    sliding_window=16,
)
