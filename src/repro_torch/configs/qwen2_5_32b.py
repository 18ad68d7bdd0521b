"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) ff=27648 V=152064.

GQA with QKV bias. [hf:Qwen/Qwen2.5-32B; hf] 40 heads are not divisible by
the 16-way model axis -> heads stay unsharded; TP lands on d_ff / d_model
(DESIGN.md §4). Full attention -> long_500k skipped.
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=27648,
    vocab=152064,
    pattern=(BlockDef("attn", "mlp"),),
    qkv_bias=True,
    norm="rmsnorm",
    tie_embeddings=False,
    supports_long=False,
)
