"""nemotron-3-nano-30b-a3b — hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16.

52 single-kind blocks by ``hybrid_override_pattern``: 23 Mamba-2, 23 MoE
and 6 attention (at layers 5, 12, 19, 26, 33, 42), each
``x + mixer(rmsnorm(x))``. d_model=2688, vocab=131072, untied head,
norm eps 1e-5. Attention: GQA 32 query / 2 KV heads of 128, no rotary
embedding (Nemotron-H applies none). Mamba-2: 64 heads of 64 (d_inner
4096), 8 B/C groups, state 128, conv 4 with bias, chunk 128, the gated
RMSNorm over groups of 512 channels. MoE: 128 relu^2 experts of 1856,
top-6 by sigmoid score + correction bias, gates renormalised and scaled
by 2.5, plus one shared relu^2 expert of 3712. 31.58B parameters, 3.23B
active without the input embedding.
"""

from repro_torch.configs.base import Family
from repro_torch.configs.pattern import PatternConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

FULL = PatternConfig(
    name="nemotron-3-nano-30b-a3b",
    family=Family.HYBRID,
    n_layers=52,
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    d_ff=1856,
    vocab_size=131072,
    head_dim=128,
    rope_theta=0.0,  # Nemotron-H's attention takes no positional encoding
    norm_eps=1e-5,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    n_experts=128,
    experts_per_token=6,
    moe_d_ff=1856,
    layer_pattern=PATTERN,
    ssm_groups=8,
    ssm_n_heads=64,
    moe_router="sigmoid_bias",
    moe_routed_scale=2.5,
    moe_act="relu2",
    shared_expert_ff=3712,
)

#: every kind of block, G > 1 and the sigmoid router, at CPU size; FULL's
#: capacity factor, so a smoke prompt drops assignments
SMOKE = PatternConfig(
    name="nemotron-3-nano-30b-a3b-smoke",
    family=Family.HYBRID,
    n_layers=7,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    head_dim=16,
    rope_theta=0.0,
    norm_eps=1e-5,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_conv=4,
    ssm_chunk=16,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    layer_pattern="MEM*EME",
    ssm_groups=2,
    ssm_n_heads=8,
    moe_router="sigmoid_bias",
    moe_routed_scale=2.5,
    moe_act="relu2",
    shared_expert_ff=48,
)
