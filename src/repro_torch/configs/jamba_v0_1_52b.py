"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) ff=14336, 16e top-2 MoE.

Mamba:attention 7:1 interleave; MoE every other layer (e:2 in the paper's
notation). Period of 8: attention at position 4 (matching the HF config's
attn_layer_offset=4), MoE on odd positions. [arXiv:2403.19887; hf]
Hybrid (mamba state + 4 attention layers) -> RUNS long_500k.
"""

from .base import ArchConfig, BlockDef, MambaSpec, MoESpec

_P = (
    BlockDef("mamba", "mlp"),
    BlockDef("mamba", "moe"),
    BlockDef("mamba", "mlp"),
    BlockDef("mamba", "moe"),
    BlockDef("attn", "mlp"),
    BlockDef("mamba", "moe"),
    BlockDef("mamba", "mlp"),
    BlockDef("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=65536,
    pattern=_P,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaSpec(expand=2, d_state=16, d_conv=4),
    norm="rmsnorm",
    tie_embeddings=True,
    supports_long=True,
)
