"""Encoder-decoder backbone on the port (whisper-base).

The port of :mod:`repro.models.encdec`. The conv audio frontend is a stub,
as in the reference: the caller supplies precomputed frame embeddings
``[B, enc_seq, D]`` (:func:`repro_torch.models.api.input_specs`). The rest
is real: a bidirectional encoder with learned positions (``enc_pos``, no
RoPE), a causal decoder whose self-attention fills a :class:`KVCache`, and
cross-attention against K/V computed once from the encoder's output and
carried in the caches. The decoder adds no positional embedding, as in the
reference. Every residual add rides a GEMM epilogue.

``params["enc_blocks"]`` and ``params["dec_blocks"]`` are lists with one
dict per layer, as ``params["blocks"]`` is in :mod:`.transformer`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from . import attention as attn_mod
from .attention import KVCache
from .layers import Initializer, embedding_init, layernorm, layernorm_init, mlp_apply, mlp_init
from .transformer import _chunked_ce, check_supported, param_dtype

__all__ = [
    "EncDecCaches",
    "init_encdec_params",
    "encode",
    "init_decoder_caches",
    "decoder_forward",
    "encdec_loss",
]


@dataclasses.dataclass
class EncDecCaches:
    """Decode state: one self-attention :class:`KVCache` a decoder layer, and
    each layer's cross-attention K/V ``[B, T_enc, H_kv, D]``."""

    self_kv: List[KVCache]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]


def _attention_init(cfg: ArchConfig, init: Initializer):
    return attn_mod.attention_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_, init)


def _enc_block_init(cfg: ArchConfig, init: Initializer, device):
    return {
        "norm1": layernorm_init(cfg.d_model, device),
        "attn": _attention_init(cfg, init),
        "norm2": layernorm_init(cfg.d_model, device),
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, init, gated=False),
    }


def _dec_block_init(cfg: ArchConfig, init: Initializer, device):
    return {
        "norm1": layernorm_init(cfg.d_model, device),
        "self_attn": _attention_init(cfg, init),
        "norm2": layernorm_init(cfg.d_model, device),
        "cross_attn": _attention_init(cfg, init),
        "norm3": layernorm_init(cfg.d_model, device),
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, init, gated=False),
    }


def init_encdec_params(
    cfg: ArchConfig, generator: Optional[torch.Generator], device: torch.device
) -> Dict[str, Any]:
    """Random parameters, drawn on ``device`` in ``cfg.param_dtype``."""
    check_supported(cfg)
    init = Initializer(dtype=param_dtype(cfg), device=device, generator=generator)
    return {
        "enc_pos": init((cfg.enc_seq, cfg.d_model)),
        "enc_blocks": [_enc_block_init(cfg, init, device) for _ in range(cfg.n_enc_layers)],
        "enc_norm": layernorm_init(cfg.d_model, device),
        "embed": embedding_init(cfg.vocab, cfg.d_model, init),
        "dec_blocks": [_dec_block_init(cfg, init, device) for _ in range(cfg.n_layers)],
        "dec_norm": layernorm_init(cfg.d_model, device),
    }


def encode(params, frames: torch.Tensor, cfg: ArchConfig, *, backend=None) -> torch.Tensor:
    """frames [B, T_enc, D] (the stub frontend's output) -> the encoder's
    final-normed states."""
    x = frames + params["enc_pos"][None].to(frames.dtype)
    for p in params["enc_blocks"]:
        x, _ = attn_mod.attention_apply(
            p["attn"], layernorm(p["norm1"], x), n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim_, rotary_frac=0.0, causal=False, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, backend=backend, residual=x,
        )
        x = mlp_apply(p["mlp"], layernorm(p["norm2"], x), activation="gelu", backend=backend,
                      residual=x)
    return layernorm(params["enc_norm"], x)


def _cross_kv(blocks, enc_out: torch.Tensor, cfg: ArchConfig, backend
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Every decoder layer's cross-attention K and V, ``[B, T, H_kv, D]``
    each, computed once from the encoder's output."""
    b, t, _ = enc_out.shape
    ks, vs = [], []
    for p in blocks:
        for w, out in ((p["cross_attn"]["wk"]["w"], ks), (p["cross_attn"]["wv"]["w"], vs)):
            out.append(ops.linear(enc_out, w, backend=backend)
                       .reshape(b, t, cfg.n_kv, cfg.head_dim_))
    return ks, vs


def init_decoder_caches(
    cfg: ArchConfig, batch: int, max_len: int, dtype, device, *, cross: bool = True
) -> EncDecCaches:
    """Zeroed self-attention caches of ``max_len`` positions and cross K/V
    of ``enc_seq`` positions, one of each a decoder layer. With
    ``cross=False`` the cross lists are empty: a prefill computes them from
    the encoder's output."""
    check_supported(cfg)
    shape = (batch, cfg.enc_seq, cfg.n_kv, cfg.head_dim_)
    n_cross = cfg.n_layers if cross else 0
    return EncDecCaches(
        self_kv=[KVCache.zeros(batch, max_len, cfg.n_kv, cfg.head_dim_, dtype, device)
                 for _ in range(cfg.n_layers)],
        cross_k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_cross)],
        cross_v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_cross)],
    )


def _dec_block(cfg: ArchConfig, p, x, ck, cv, kv, backend):
    """One decoder layer: causal self-attention (filling or reading ``kv``),
    cross-attention against ``ck``/``cv``, the un-gated GELU MLP; each
    residual add fused into its block's last GEMM."""
    b, s, _ = x.shape
    x, new_kv = attn_mod.attention_apply(
        p["self_attn"], layernorm(p["norm1"], x), n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim_, rotary_frac=0.0, causal=True, cache=kv, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk, backend=backend, residual=x,
    )
    q = ops.linear(layernorm(p["norm2"], x), p["cross_attn"]["wq"]["w"], backend=backend)
    o = attn_mod.blockwise_attention(
        q.reshape(b, s, cfg.n_heads, cfg.head_dim_), ck, cv, causal=False,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
    )
    x = ops.matmul(o.reshape(b, s, cfg.n_heads * cfg.head_dim_), p["cross_attn"]["wo"]["w"],
                   backend=backend, epilogue=[("residual", x)])
    x = mlp_apply(p["mlp"], layernorm(p["norm3"], x), activation="gelu", backend=backend,
                  residual=x)
    return x, new_kv


def decoder_forward(
    params,
    tokens: torch.Tensor,
    cfg: ArchConfig,
    *,
    enc_out: Optional[torch.Tensor] = None,
    caches: Optional[EncDecCaches] = None,
    mode: str = "train",
    backend=None,
) -> Tuple[torch.Tensor, Optional[EncDecCaches]]:
    """The decoder over ``tokens`` [B, S]. Cross K/V come from ``enc_out``
    (train, prefill) or from ``caches`` (decode). Returns (final-normed
    hidden [B, S, D], the new caches or None). In train mode with
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint`` of its layer-scan body."""
    x = params["embed"]["table"][tokens]
    if enc_out is not None:
        ck, cv = _cross_kv(params["dec_blocks"], enc_out, cfg, backend)
    else:
        ck, cv = caches.cross_k, caches.cross_v
    remat = cfg.remat and mode == "train"
    new_kv: List[KVCache] = []
    for i, p in enumerate(params["dec_blocks"]):
        kv = caches.self_kv[i] if caches is not None else None
        if remat and kv is None:
            x, nkv = torch.utils.checkpoint.checkpoint(
                _dec_block, cfg, p, x, ck[i], cv[i], None, backend, use_reentrant=False)
        else:
            x, nkv = _dec_block(cfg, p, x, ck[i], cv[i], kv, backend)
        new_kv.append(nkv)
    x = layernorm(params["dec_norm"], x)
    if caches is None:
        return x, None
    return x, EncDecCaches(self_kv=new_kv, cross_k=ck, cross_v=cv)


def encdec_loss(
    params, frames: torch.Tensor, tokens: torch.Tensor, labels: torch.Tensor,
    cfg: ArchConfig, *, backend=None,
) -> torch.Tensor:
    """Training loss: the encoder, the train-mode decoder and the chunked
    cross-entropy against the tied table."""
    enc_out = encode(params, frames, cfg, backend=backend)
    hidden, _ = decoder_forward(params, tokens, cfg, enc_out=enc_out, mode="train",
                                backend=backend)
    return _chunked_ce(params, hidden, labels, cfg)
