"""jamba-v0.1-52b — Mamba+attention 1:7 interleave with MoE, arXiv:2403.19887.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2
on every other layer. Attention at position 4 of each 8-layer block (1:7
attn:mamba). Mamba layers use the SSD (Mamba-2) mixer with the published
Mamba-1 dims (d_state 16, conv 4, expand 2) — substitution noted in DESIGN.md.
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family=Family.HYBRID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    rope_theta=0.0,  # jamba uses no positional encoding (mamba provides order)
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    # chunk 128: the intra-chunk (L,L,H) duality tensors dominate the SSD
    # working set; 128 keeps them MXU-aligned at a quarter of the 256 cost
    # (§Perf iteration 1 on the jamba cell)
    ssm_chunk=128,
    attn_period=8,
    attn_offset=4,
    n_experts=16,
    experts_per_token=2,
    moe_period=2,
    moe_offset=1,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family=Family.HYBRID,
    n_layers=8,  # one full super-block (attn at 4, MoE at odd layers)
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    head_dim=16,
    rope_theta=0.0,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=16,
    attn_period=8,
    attn_offset=4,
    n_experts=4,
    experts_per_token=2,
    moe_capacity_factor=8.0,  # drop-free at smoke scale (tests compare paths)
    moe_period=2,
    moe_offset=1,
)
