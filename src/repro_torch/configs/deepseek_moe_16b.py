"""deepseek-moe-16b [moe]: 28L d=2048 16H ff=1408 V=102400, 64e top-6 + 2 shared.

Fine-grained experts (d_ff_expert=1408), 2 shared experts always active.
First layer is a dense MLP (the HF config's first_k_dense_replace=1 is
folded into the pattern as layer 0 dense + 27 MoE layers is approximated by
a uniform MoE pattern; deviation noted in DESIGN.md). [arXiv:2401.06066; hf]
EP: 64 experts / 16-way model axis = 4 per shard.
"""

from .base import ArchConfig, BlockDef, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=102400,
    pattern=(BlockDef("attn", "moe"),),
    moe=MoESpec(
        n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, d_ff_shared=2816
    ),
    norm="rmsnorm",
    tie_embeddings=True,
    supports_long=False,
)
