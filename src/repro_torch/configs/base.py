"""Architecture / shape configuration schema.

Every assigned architecture is a frozen :class:`ArchConfig`; the four
assigned input shapes are :class:`ShapeConfig` instances. A config fully
determines the model pytree, the block program (``pattern`` — the repeating
period of heterogeneous layers that the layer-scan iterates), the sharding
rules, and the applicable shape cells (``supports_long`` / ``has_decoder``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = [
    "MoESpec",
    "MambaSpec",
    "BlockDef",
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: Optional[int] = None  # defaults to n_shared * d_ff_expert
    capacity_factor: float = 1.25
    dispatch: str = "onehot"  # paper-faithful baseline; "sort" = optimized
    group_size: int = 512  # routing group (per-group capacity, local sorts)
    # Dropless routing (capacity = group size, so no assignment can overflow).
    # Token-choice capacity dropping makes autoregressive decode diverge from
    # teacher forcing (drop decisions depend on the whole token group, which
    # a decode step cannot see); consistency-critical configs set this.
    dropless: bool = False


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer of the repeating period."""

    mixer: str  # attn | attn_local | mamba | mlstm | slstm | none
    ffn: str  # mlp | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    pattern: Tuple[BlockDef, ...]
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_frac: float = 1.0  # chatglm3 2-D RoPE: 0.5
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window for attn_local blocks
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    qkv_bias: bool = False  # qwen2.5
    parallel_block: bool = False  # stablelm: attn + mlp share the residual
    tie_embeddings: bool = True
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    # encoder-decoder (whisper): encoder depth & fixed source length
    n_enc_layers: int = 0
    enc_seq: int = 0
    # VLM (llava): number of stub patch-embedding tokens prepended
    n_img_tokens: int = 0
    supports_long: bool = False  # runs the long_500k cell (SSM/hybrid only)
    param_dtype: str = "bfloat16"
    # execution knobs (hillclimb surface)
    q_chunk: int = 512
    kv_chunk: int = 1024
    scan_chunk: int = 64  # mamba / mlstm chunk length
    loss_chunk: int = 512  # vocab-CE token chunking
    grad_accum: int = 1
    remat: bool = True
    remat_policy: str = "full"  # full | dots | none (§Perf knob)
    attn_seq_shard: bool = False  # context-parallel attention core (§Perf)
    moment_dtype: str = "float32"  # grok: bfloat16 to fit HBM

    def __post_init__(self) -> None:
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern length {len(self.pattern)}"
            )
        if self.n_heads % max(self.n_kv, 1):
            raise ValueError(f"{self.name}: n_heads % n_kv != 0")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # all 10 assigned archs decode (whisper via its decoder)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (one period, small dims)."""
        hd = 16
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, self.n_kv if self.n_kv <= n_heads else n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        moe = (
            dataclasses.replace(
                self.moe,
                n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                d_ff_expert=32,
                d_ff_shared=32 if self.moe.n_shared else None,
                # Smoke tests check prefill+decode against teacher forcing;
                # with an untrained (imbalanced) router, capacity dropping
                # would make those paths disagree by construction.
                dropless=True,
            )
            if self.moe
            else None
        )
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=len(self.pattern),
            d_model=n_heads * hd,
            n_heads=n_heads,
            n_kv=n_kv,
            head_dim=hd,
            d_ff=96 if self.d_ff else 0,
            vocab=256,
            window=min(self.window, 16) if self.window else None,
            moe=moe,
            n_enc_layers=1 if self.n_enc_layers else 0,
            enc_seq=24 if self.enc_seq else 0,
            n_img_tokens=8 if self.n_img_tokens else 0,
            param_dtype="float32",
            q_chunk=16,
            kv_chunk=16,
            scan_chunk=8,
            loss_chunk=32,
            grad_accum=1,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The assigned cells for this arch (long_500k only for SSM/hybrid)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.supports_long:
            continue
        out.append(s)
    return tuple(out)
