"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H ff=2048 V=51865.

Enc-dec with conv frontend STUB: input_specs() provides precomputed frame
embeddings [B, 1500, 512]. Vocab 51865 is not divisible by the 16-way model
axis -> embedding unsharded on vocab (the model is 72M params; irrelevant).
[arXiv:2212.04356; unverified]
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_ff=2048,
    vocab=51865,
    pattern=(BlockDef("attn", "mlp"),),
    norm="layernorm",
    rope_frac=0.0,  # whisper uses absolute positions, no RoPE
    tie_embeddings=True,
    n_enc_layers=6,
    enc_seq=1500,
    supports_long=False,
)
