"""llava-next-mistral-7b [vlm]: mistral-7b backbone, anyres stub frontend.

32L d=4096 32H (GQA kv=8) ff=14336 V=32000. The vision tower is a stub:
input_specs() provides precomputed patch embeddings [B, 2880, d_model]
(base 576 + 4 anyres tiles x 576). The multimodal projector is real.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Full attention -> long_500k skipped.
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    pattern=(BlockDef("attn", "mlp"),),
    norm="rmsnorm",
    tie_embeddings=False,
    n_img_tokens=2880,
    supports_long=False,
)
