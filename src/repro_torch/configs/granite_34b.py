"""granite-34b — code model with MQA, arXiv:2405.04324.

88L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576 vocab=49152, head_dim 128.
The fc-gelu-fc MLP (GPT-BigCode lineage) lands the published 34B total —
SwiGLU would give 47B. RoPE retained for uniformity (the released 34B uses
learned absolute positions; noted in DESIGN.md §8).
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="granite-34b",
    family=Family.DENSE,
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=1e4,
    mlp_gelu=True,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family=Family.DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=1e4,
    mlp_gelu=True,
)
