"""xlstm-125m [ssm]: 12L d=768 4H V=50304; alternating sLSTM/mLSTM blocks.

[arXiv:2405.04517; unverified] 1:1 alternation (the paper sweeps ratios);
mLSTM chunkwise-parallel for train/prefill, exact recurrence for decode.
Sequence-independent state -> RUNS long_500k.
"""

from .base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv=4,
    d_ff=3072,  # post-up-proj FFN width (assignment lists d_ff=0: the xLSTM
    # block has no separate FFN; we keep ffn="none" below and use
    # this only for the reduced smoke config sizing)
    vocab=50304,
    pattern=(BlockDef("slstm", "none"), BlockDef("mlstm", "none")),
    norm="layernorm",
    tie_embeddings=True,
    supports_long=True,
)
