"""Decoder-only LM assembly: a Python loop over layers.

The port of :mod:`repro.models.transformer` for the ``("attn", "mlp")``
block pattern (the dense decoders such as chatglm3-6b) and the
``("attn", "moe")`` pattern (the MoE decoders such as deepseek-moe-16b).
Parameters are a dict; ``params["blocks"]`` is a list with one dict per
layer, in place of the reference's per-period stacks under ``lax.scan``.
Caches are a list of one :class:`KVCache` per layer.

Modes: ``prefill`` (full sequence, fills the caches) and ``decode`` (one
token against the caches); without caches a prefill returns hidden states
only. ``lm_forward`` also returns the MoE router's load-balancing loss,
summed over layers, as the reference does. Other block patterns raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, BlockDef
from repro_torch.kernels.opope_gemm import full_fp32
from . import attention as attn_mod
from .attention import KVCache
from .layers import (
    Initializer,
    embedding_init,
    layernorm,
    layernorm_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
)
from .moe import moe_apply, moe_init

__all__ = [
    "check_supported",
    "param_dtype",
    "init_lm_params",
    "init_caches",
    "lm_forward",
    "lm_logits",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


_PORTED = {
    "dense": (BlockDef("attn", "mlp"),),
    "moe": (BlockDef("attn", "moe"),),
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port lacks."""
    if _PORTED.get(cfg.family) != cfg.pattern or (cfg.family == "moe") != (cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: only the dense ('attn', 'mlp') and MoE ('attn', 'moe') "
            f"patterns are ported; got family {cfg.family!r}, pattern {cfg.pattern}"
        )
    if cfg.parallel_block or cfg.window or cfg.attn_softcap:
        raise NotImplementedError(
            f"{cfg.name}: parallel blocks, sliding windows and attention "
            f"soft-capping are not ported yet"
        )


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _norm_init(cfg: ArchConfig, d: int, device):
    return rmsnorm_init(d, device) if cfg.norm == "rmsnorm" else layernorm_init(d, device)


def _norm(cfg: ArchConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def init_lm_params(
    cfg: ArchConfig, generator: Optional[torch.Generator], device: torch.device
) -> Dict[str, Any]:
    """Random parameters, drawn on ``device`` in ``cfg.param_dtype``."""
    check_supported(cfg)
    init = Initializer(dtype=param_dtype(cfg), device=device, generator=generator)
    params: Dict[str, Any] = {
        "embed": embedding_init(cfg.vocab, cfg.d_model, init),
        "final_norm": _norm_init(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((cfg.vocab, cfg.d_model))
    blocks: List[Dict[str, Any]] = []
    for _ in range(cfg.n_layers):
        block = {
            "norm_mixer": _norm_init(cfg, cfg.d_model, device),
            "attn": attn_mod.attention_init(
                cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_, init,
                qkv_bias=cfg.qkv_bias,
            ),
            "norm_ffn": _norm_init(cfg, cfg.d_model, device),
        }
        if cfg.moe is None:
            block["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, init)
        else:
            block["moe"] = moe_init(
                cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts, init,
                n_shared=cfg.moe.n_shared, d_ff_shared=cfg.moe.d_ff_shared,
            )
        blocks.append(block)
    params["blocks"] = blocks
    return params


def init_caches(
    cfg: ArchConfig, batch: int, max_len: int, dtype, device
) -> List[KVCache]:
    """One zeroed KV cache per layer."""
    check_supported(cfg)
    return [
        KVCache.zeros(batch, max_len, cfg.n_kv, cfg.head_dim_, dtype, device)
        for _ in range(cfg.n_layers)
    ]


def _block_apply(cfg: ArchConfig, p, x, *, positions, cache, backend):
    """One layer: attention with its skip connection fused into the output
    projection, then the pre-norm MLP with its skip fused into w_down, or
    the pre-norm MoE with a plain skip add. Returns (x, new_cache, aux loss
    or None)."""
    stream, new_cache = attn_mod.attention_apply(
        p["attn"],
        _norm(cfg, p["norm_mixer"], x),
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        head_dim=cfg.head_dim_,
        positions=positions,
        rotary_frac=cfg.rope_frac,
        rope_theta=cfg.rope_theta,
        cache=cache,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
        backend=backend,
        residual=x,
    )
    h = _norm(cfg, p["norm_ffn"], stream)
    if "mlp" in p:
        return mlp_apply(p["mlp"], h, backend=backend, residual=stream), new_cache, None
    moe = cfg.moe
    y, aux = moe_apply(
        p["moe"], h, n_experts=moe.n_experts, top_k=moe.top_k,
        capacity_factor=moe.capacity_factor, dispatch=moe.dispatch,
        group_size=moe.group_size, dropless=moe.dropless, backend=backend,
    )
    # The MoE output is a weighted expert combine, not a bare GEMM
    # writeback, so its skip connection stays a plain add.
    return stream + y, new_cache, aux


def lm_forward(
    params,
    tokens: torch.Tensor,
    cfg: ArchConfig,
    *,
    mode: str = "prefill",
    caches: Optional[List[KVCache]] = None,
    positions: Optional[torch.Tensor] = None,
    backend=None,
) -> Tuple[torch.Tensor, Optional[List[KVCache]], torch.Tensor]:
    """Run the backbone. tokens: [B, S] -> (final-normed hidden [B, S, D],
    new caches or None, the MoE load-balancing loss summed over layers as a
    0-d fp32 tensor, zero without MoE layers). ``backend`` is a backend name
    or a precision policy; each GEMM site resolves its own role."""
    check_supported(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"lm_forward mode {mode!r} is not ported yet")
    x = params["embed"]["table"][tokens]
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    new_caches: Optional[List[KVCache]] = [] if caches is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p in enumerate(params["blocks"]):
        cache = caches[layer] if caches is not None else None
        x, nc, a = _block_apply(cfg, p, x, positions=positions, cache=cache, backend=backend)
        if a is not None:
            aux = aux + a
        if new_caches is not None:
            new_caches.append(nc)
    return _norm(cfg, params["final_norm"], x), new_caches, aux


def lm_logits(params, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits [B, S, V] from fp32 products (TF32 off), as the reference's
    einsum with ``preferred_element_type=float32``."""
    table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    with full_fp32():
        logits = hidden.float() @ table.float().t()
    return softcap(logits, cfg.final_softcap)
