"""mamba2-780m — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1536, attention-free (d_ff=0: the Mamba-2 block is the whole
layer), vocab 50280, ssm_state N=128, head_dim P=64, expand 2 (d_inner 3072,
48 SSM heads), conv width 4. Embeddings tied (mamba convention).
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="mamba2-780m",
    family=Family.SSM,
    n_layers=48,
    d_model=1536,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    rope_theta=0.0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family=Family.SSM,
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    rope_theta=0.0,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
)
