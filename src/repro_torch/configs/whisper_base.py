"""whisper-base — encoder-decoder ASR, arXiv:2212.04356.

6L encoder + 6L decoder, d_model=512, 8H (MHA), d_ff=2048 (fc-gelu-fc),
vocab 51865. The conv mel frontend is a STUB — ``input_specs`` provides
precomputed frame embeddings (B, 1500, d_model). Decoder uses a learned
position table (448 published positions; the decode_32k cell extends the
table mechanically — noted in DESIGN.md).
"""

from repro_torch.configs.base import Family, ModelConfig

FULL = ModelConfig(
    name="whisper-base",
    family=Family.AUDIO,
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    rope_theta=0.0,  # absolute position embeddings, not rotary
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq=1500,
    max_position_embeddings=448,
    mlp_gelu=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    family=Family.AUDIO,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=0.0,
    is_encoder_decoder=True,
    n_encoder_layers=2,
    encoder_seq=32,
    max_position_embeddings=64,
    mlp_gelu=True,
    tie_embeddings=True,
)
