"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8) ff=14336 V=256000.

Alternating local(4096-window)/global attention, attn softcap 50, final
logit softcap 30. [arXiv:2408.00118; hf] Global layers are full attention ->
long_500k skipped.
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,  # gemma2-9b uses 256-wide heads (16 x 256 = 4096 > d_model)
    pattern=(BlockDef("attn_local", "mlp"), BlockDef("attn", "mlp")),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm="rmsnorm",
    tie_embeddings=True,
    supports_long=False,
)
