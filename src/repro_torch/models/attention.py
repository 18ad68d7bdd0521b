"""GQA attention with O-POPE-style blockwise accumulation.

The port of :mod:`repro.models.attention` for the serving path: projections
on the O-POPE GEMM, RoPE, and the attention core in plain PyTorch — as in
the reference, where attention is jnp and not a Pallas kernel. Scores and
softmax are fp32; the probabilities are rounded to the value dtype and the PV
product accumulates in fp32. Masks use the finite ``NEG_INF``, so a fully
masked row gives uniform weights, not NaN.

Caches are updated in place (the reference builds new arrays): a decode step
writes one position per row into the pool's buffers instead of copying them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from .layers import Initializer, apply_rope, dense_init, role_backend

__all__ = [
    "NEG_INF",
    "KVCache",
    "attention_init",
    "attention_apply",
    "blockwise_attention",
    "decode_attention",
]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class KVCache:
    """Decode-time cache. k/v: [B, S_max, H_kv * D] (heads fused); ``length``
    is the fill point: an ``int`` when every row advances in lockstep, or an
    int64 ``[B]`` tensor when rows are independently positioned slots."""

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor] = 0

    @staticmethod
    def zeros(batch: int, max_len: int, n_kv: int, head_dim: int, dtype, device) -> "KVCache":
        shape = (batch, max_len, n_kv * head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=0,
        )


def attention_init(
    d_model: int, n_heads: int, n_kv: int, head_dim: int, init: Initializer,
    *, qkv_bias: bool = False,
):
    return {
        "wq": dense_init(d_model, n_heads * head_dim, init, bias=qkv_bias),
        "wk": dense_init(d_model, n_kv * head_dim, init, bias=qkv_bias),
        "wv": dense_init(d_model, n_kv * head_dim, init, bias=qkv_bias),
        "wo": dense_init(n_heads * head_dim, d_model, init),
    }


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, qc, Hkv, G, D] x [B, kc, Hkv, D] -> fp32 [B, Hkv, G, qc, kc]."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Probabilities rounded to the value dtype, fp32 accumulation."""
    return torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention. q: [B,S,Hq,D]; k/v: [B,T,Hkv,D] -> [B,S,Hq,D].

    Query blocks of ``q_chunk`` rows stream KV panels of ``kv_chunk`` keys,
    keeping the softmax state ``(m, l, acc)`` in fp32; causality prunes
    whole panels.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qc = min(q_chunk, s)
    while s % qc:
        qc -= 1
    kc = min(kv_chunk, t)
    while t % kc:
        kc -= 1
    nq, nkv = s // qc, t // kc
    qg = q.reshape(b, nq, qc, hkv, g, d)
    kr = k.reshape(b, nkv, kc, hkv, d)
    vr = v.reshape(b, nkv, kc, hkv, d)
    k_pos = torch.arange(t, device=q.device).reshape(nkv, kc)

    outs = []
    for i in range(nq):
        q_i = qg[:, i]
        q_pos = i * qc + torch.arange(qc, device=q.device)
        hi = nkv if not causal else min(nkv, math.ceil((i + 1) * qc / kc))
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, d), dtype=torch.float32, device=q.device)
        for j in range(hi):
            s_ij = _scores(q_i, kr[:, j], scale)
            if causal:
                mask = k_pos[j][None, :] <= q_pos[:, None]
                s_ij = torch.where(mask, s_ij, NEG_INF)
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            p = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, vr[:, j])
            m = m_new
        out_i = acc / torch.clamp(l[..., None], min=1e-37)
        outs.append(out_i.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    *,
    n_kv: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against the cache. q: [B,1,Hq,D] -> [B,1,Hq,D].
    Row ``b`` attends over positions ``< length[b]`` (or ``< length``)."""
    b, _, hq, d = q.shape
    t = cache.k.shape[1]
    g = hq // n_kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, 1, n_kv, g, d)
    k = cache.k.reshape(b, t, n_kv, d)
    v = cache.v.reshape(b, t, n_kv, d)
    s = _scores(qg, k, scale)  # [B, Hkv, G, 1, T]
    kp = torch.arange(t, device=q.device)
    ln = torch.as_tensor(cache.length, device=q.device).reshape(-1)
    valid = kp[None, :] < ln[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, d).to(q.dtype)


def _append(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """Write one token per row at the fill point, in place; returns the
    cache advanced by one. Per-slot positions past the buffer are dropped."""
    b = k.shape[0]
    kf = k.reshape(b, -1).to(cache.k.dtype)
    vf = v.reshape(b, -1).to(cache.v.dtype)
    if isinstance(cache.length, torch.Tensor):
        idx = cache.length
        t = cache.k.shape[1]
        rows = torch.arange(b, device=k.device)
        at = idx.clamp(max=t - 1)
        keep = (idx < t)[:, None]
        cache.k[rows, at] = torch.where(keep, kf, cache.k[rows, at])
        cache.v[rows, at] = torch.where(keep, vf, cache.v[rows, at])
        return KVCache(cache.k, cache.v, idx + 1)
    cache.k[:, cache.length] = kf
    cache.v[:, cache.length] = vf
    return KVCache(cache.k, cache.v, cache.length + 1)


def attention_apply(
    params,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: Optional[torch.Tensor] = None,
    rotary_frac: float = 1.0,
    rope_theta: float = 10000.0,
    causal: bool = True,
    cache: Optional[KVCache] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    backend=None,
    residual: Optional[torch.Tensor] = None,
    chunk: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Attention block: QKV projections (bias on the C preload), RoPE, core,
    and the output projection with ``residual`` fused into its epilogue.

    Modes: ``cache is None`` — prefill without cache; ``cache`` and one token
    — decode (append, attend); ``cache`` and a longer ``x`` — prefill that
    fills and returns the cache. Chunked prefill is not ported yet. The
    projections take the policy roles ``attn_qkv`` and ``attn_out``.
    """
    if chunk:
        raise NotImplementedError("chunked prefill is not ported yet")
    b, s, _ = x.shape
    qkv_be = role_backend(backend, "attn_qkv")
    q = ops.linear(x, params["wq"]["w"], params["wq"].get("b"), backend=qkv_be)
    k = ops.linear(x, params["wk"]["w"], params["wk"].get("b"), backend=qkv_be)
    v = ops.linear(x, params["wv"]["w"], params["wv"].get("b"), backend=qkv_be)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv, head_dim)
    v = v.reshape(b, s, n_kv, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if rotary_frac > 0:
        q = apply_rope(q, positions, rotary_frac=rotary_frac, theta=rope_theta)
        k = apply_rope(k, positions, rotary_frac=rotary_frac, theta=rope_theta)

    new_cache = None
    if cache is not None and s == 1:
        new_cache = _append(cache, k, v)
        o = decode_attention(q, new_cache, n_kv=n_kv)
    else:
        o = blockwise_attention(
            q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk
        )
        if cache is not None:
            cache.k[:, :s] = k.reshape(b, s, n_kv * head_dim).to(cache.k.dtype)
            cache.v[:, :s] = v.reshape(b, s, n_kv * head_dim).to(cache.v.dtype)
            new_cache = KVCache(cache.k, cache.v, s)
    out = ops.matmul(
        o.reshape(b, s, n_heads * head_dim), params["wo"]["w"],
        backend=role_backend(backend, "attn_out"),
        epilogue=[("residual", residual)] if residual is not None else None,
    )
    return out, new_cache
