"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) ff=32768 V=131072, 8e top-2.

[hf:xai-org/grok-1; unverified] E=8 does not divide the 16-way model axis ->
TP inside experts (d_ff 32768/16); bf16 optimizer moments + 8x grad
accumulation to fit 16 GB/chip (DESIGN.md §4; fit proven by memory_analysis).
Full attention -> long_500k skipped.
"""

from .base import ArchConfig, BlockDef, MoESpec

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=32768,  # dense-equivalent width; experts use d_ff_expert below
    vocab=131072,
    pattern=(BlockDef("attn", "moe"),),
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=32768),
    norm="rmsnorm",
    tie_embeddings=True,
    supports_long=False,
    grad_accum=8,
    moment_dtype="bfloat16",
)
