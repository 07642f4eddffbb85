"""moonshot-v1-16b-a3b — kimi/Moonlight MoE, hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H (GQA kv=16) vocab=163840, MoE 64 experts top-6 with
expert hidden dim 1408. (The released model adds shared experts and a dense
first layer — simplified to uniform MoE here; noted in DESIGN.md.)
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family=Family.MOE,
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    rope_theta=5e4,
    n_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family=Family.MOE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    head_dim=16,
    rope_theta=5e4,
    n_experts=8,
    experts_per_token=2,
    moe_capacity_factor=8.0,  # drop-free at smoke scale (tests compare paths)
    moe_d_ff=32,
)
