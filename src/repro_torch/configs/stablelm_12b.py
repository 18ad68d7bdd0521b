"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=13824 V=100352.

Parallel attention+MLP block (StableLM-2 style), LayerNorm.
[hf:stabilityai/stablelm-2-12b; hf] Full attention -> long_500k skipped.
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    d_ff=13824,
    vocab=100352,
    pattern=(BlockDef("attn", "mlp"),),
    parallel_block=True,
    norm="layernorm",
    tie_embeddings=False,
    supports_long=False,
)
