"""qwen2-vl-7b — VLM decoder backbone with M-RoPE, arXiv:2409.12191.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, head_dim 128.
M-RoPE: (t, h, w) position streams own (16, 24, 24) channels of head_dim/2.
The dynamic-resolution vision frontend is a STUB — ``input_specs`` provides
precomputed patch embeddings (B, P, d_model); the backbone splices them over
the first P token positions.
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b",
    family=Family.VLM,
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_patches=1024,  # stub frontend: 1024 patch embeddings per sequence
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke",
    family=Family.VLM,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=1e6,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(2, 3, 3),
    vision_patches=8,
)
