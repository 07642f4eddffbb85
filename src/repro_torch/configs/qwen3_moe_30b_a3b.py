"""qwen3-moe-30b-a3b — hf:Qwen/Qwen3-30B-A3B.

48L d_model=2048 32H (GQA kv=4) vocab=151936, MoE 128 experts top-8 with
expert hidden dim 768, head_dim 128.
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=Family.MOE,
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1e6,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family=Family.MOE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    head_dim=16,
    rope_theta=1e6,
    n_experts=8,
    experts_per_token=2,
    moe_capacity_factor=8.0,  # drop-free at smoke scale (tests compare paths)
    moe_d_ff=32,
)
