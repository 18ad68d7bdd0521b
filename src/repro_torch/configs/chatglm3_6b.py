"""chatglm3-6b [dense]: 28L d=4096 32H (GQA kv=2) ff=13696 V=65024.

2-D RoPE (rotary over half the head dim), GQA. [arXiv:2406.12793; hf]
Pure full attention -> long_500k skipped (DESIGN.md §5).
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=65024,
    pattern=(BlockDef("attn", "mlp"),),
    rope_frac=0.5,  # 2-D RoPE: rotate half the head dimensions
    norm="rmsnorm",
    tie_embeddings=False,
    supports_long=False,
)
