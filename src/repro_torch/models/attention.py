"""GQA attention with O-POPE-style blockwise accumulation.

The port of :mod:`repro.models.attention` for the serving path: projections
on the O-POPE GEMM, RoPE, and the attention core in plain PyTorch — as in
the reference, where attention is jnp and not a Pallas kernel. The core
takes a sliding window (gemma2's local layers) and score soft-capping in
each mode, in the reference's order: scale, cap, then the masks. Scores and
softmax are fp32; the probabilities are rounded to the value dtype and the PV
product accumulates in fp32. Masks use the finite ``NEG_INF``, so a fully
masked row gives uniform weights, not NaN.

Caches are updated in place (the reference builds new arrays): a decode step
writes one position per row into the pool's buffers instead of copying them,
and a chunk of prefill writes its positions of each row. A
:class:`~repro_torch.quant.kvcache.QuantKVCache` takes the decode step only:
the appended token is quantized through the slot's scales, and attention
reads an fp32 view dequantized inside the step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.quant.kvcache import QuantKVCache
from .layers import Initializer, apply_rope, dense_init, role_backend

__all__ = [
    "NEG_INF",
    "KVCache",
    "attention_init",
    "attention_apply",
    "blockwise_attention",
    "chunk_attention",
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


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            cap: Optional[float] = None) -> torch.Tensor:
    """[B, qc, Hkv, G, D] x [B, kc, Hkv, D] -> fp32 [B, Hkv, G, qc, kc]:
    scaled, then soft-capped to ``cap * tanh(s / cap)`` when ``cap`` is set."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    return s


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Probabilities rounded to the value dtype, fp32 accumulation."""
    return torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention. q: [B,S,Hq,D]; k/v: [B,T,Hkv,D] -> [B,S,Hq,D].

    Query blocks of ``q_chunk`` rows stream KV panels of ``kv_chunk`` keys,
    keeping the softmax state ``(m, l, acc)`` in fp32; causality and a
    sliding ``window`` (key ``kp`` is seen by query ``q`` iff
    ``kp > q - window``) prune whole panels. ``attn_softcap`` caps the
    scaled scores before the masks.
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
        lo = 0 if window is None else max(0, (i * qc - window) // kc)
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, d), dtype=torch.float32, device=q.device)
        for j in range(lo, hi):
            s_ij = _scores(q_i, kr[:, j], scale, attn_softcap)
            mask = _panel_mask(k_pos[j], q_pos, causal, window)
            if mask is not None:
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


def _panel_mask(k_pos: torch.Tensor, q_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> Optional[torch.Tensor]:
    """[qc, kc] validity of a panel's keys for a block's queries, or None
    when every key is valid."""
    mask = None
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        in_window = k_pos[None, :] > q_pos[:, None] - window
        mask = in_window if mask is None else mask & in_window
    return mask


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    *,
    n_kv: int,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against the cache. q: [B,1,Hq,D] -> [B,1,Hq,D].
    Row ``b`` attends over positions ``< length[b]`` (or ``< length``), and
    with a ``window`` only over the last ``window`` of them."""
    b, _, hq, d = q.shape
    t = cache.k.shape[1]
    g = hq // n_kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, 1, n_kv, g, d)
    k = cache.k.reshape(b, t, n_kv, d)
    v = cache.v.reshape(b, t, n_kv, d)
    s = _scores(qg, k, scale, attn_softcap)  # [B, Hkv, G, 1, T]
    kp = torch.arange(t, device=q.device)
    ln = torch.as_tensor(cache.length, device=q.device).reshape(-1)
    valid = kp[None, :] < ln[:, None]
    if window is not None:
        valid = valid & (kp[None, :] > ln[:, None] - 1 - window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, d).to(q.dtype)


def chunk_attention(
    q: torch.Tensor,
    cache: KVCache,
    q_pos: torch.Tensor,
    *,
    n_kv: int,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: C query tokens per row, each at its own
    absolute position, against the row's cache. q: [B,C,Hq,D]; q_pos: [B,C]
    -> [B,C,Hq,D]. Token ``(b, j)`` attends over every cache position
    ``<= q_pos[b, j]`` (and ``> q_pos[b, j] - window`` with a window): the
    chunk's own K/V is already in the cache, so causality inside the chunk
    and attention over earlier chunks (or an attached cached prefix) are
    one mask, and rows may sit at different offsets."""
    b, c, hq, d = q.shape
    t = cache.k.shape[1]
    g = hq // n_kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, c, n_kv, g, d)
    k = cache.k.reshape(b, t, n_kv, d)
    v = cache.v.reshape(b, t, n_kv, d)
    s = _scores(qg, k, scale, attn_softcap)  # [B, Hkv, G, C, T]
    kp = torch.arange(t, device=q.device)
    valid = kp[None, None, :] <= q_pos[:, :, None]  # [B, C, T]
    if window is not None:
        valid = valid & (kp[None, None, :] > q_pos[:, :, None] - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, hq, d).to(q.dtype)


def _append(cache, k: torch.Tensor, v: torch.Tensor):
    """Write one token per row at the fill point, in place; returns the
    cache advanced by one. Per-slot positions past the buffer are dropped.
    ``k``/``v`` are already in the cache's dtype for a ``QuantKVCache``."""
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
        return dataclasses.replace(cache, length=idx + 1)
    cache.k[:, cache.length] = kf
    cache.v[:, cache.length] = vf
    return dataclasses.replace(cache, length=cache.length + 1)


def _scatter_chunk(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor) -> None:
    """``cache.k[b, positions[b, j]] = k[b, j]`` (and ``v``) in place, for
    k/v ``[B, C, fused]``; writes at positions ``>= S_max`` drop. Each cache
    position takes the chunk token that targets it, found by comparison, so
    no two writes land on one element (an index write with the dropped
    positions clamped would collide with a kept write at ``S_max - 1``) and
    nothing waits on the host."""
    t = cache.k.shape[1]
    hit = positions[:, None, :] == torch.arange(t, device=positions.device)[None, :, None]
    src = hit.to(torch.int64).argmax(dim=-1)[..., None]  # [B, T, 1]: the chunk index
    written = hit.any(dim=-1)[..., None]
    for buf, x in ((cache.k, k), (cache.v, v)):
        vals = torch.gather(x.to(buf.dtype), 1, src.expand(-1, -1, x.shape[-1]))
        buf.copy_(torch.where(written, vals, buf))


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
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    cache: Optional[KVCache] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    backend=None,
    residual: Optional[torch.Tensor] = None,
    chunk: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Attention block: QKV projections (bias on the C preload), RoPE, core,
    and the output projection with ``residual`` fused into its epilogue.

    Modes: ``cache is None`` — prefill without cache; ``cache`` and
    ``chunk=True`` — chunked prefill: write the C tokens' K/V at the per-row
    ``positions`` (which may start past 0, and at or past ``S_max`` for a
    row with nothing to write), attend over each row's history; ``cache``
    and one token — decode (append, attend); ``cache`` and a longer ``x`` —
    prefill that fills and returns the cache. A ``QuantKVCache`` takes the
    decode step only: chunks and prefills fill full-precision caches, which
    the slot pool's join quantizes. The projections take the policy roles
    ``attn_qkv`` and ``attn_out``. ``window`` (a local layer's sliding
    window) and ``attn_softcap`` reach the attention core in every mode.
    """
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
    if cache is not None and chunk and s > 1:
        if isinstance(cache, QuantKVCache):
            raise NotImplementedError(
                "chunked prefill into a QuantKVCache is unsupported: chunk into "
                "a full-precision cache and quantize at the slot-pool join "
                "(serve.cache.scatter_slots)"
            )
        _scatter_chunk(cache, k.reshape(b, s, -1), v.reshape(b, s, -1), positions)
        new_cache = KVCache(cache.k, cache.v, positions[:, -1] + 1)
        o = chunk_attention(q, new_cache, positions, n_kv=n_kv, window=window,
                            attn_softcap=attn_softcap)
    elif cache is not None and s == 1:
        if isinstance(cache, QuantKVCache):
            # The appended token quantizes through the slot's fixed scales;
            # attention reads an fp32 view dequantized here, in the step.
            kq, vq = cache.quantize_rows(k.reshape(b, -1), v.reshape(b, -1))
            new_cache = _append(cache, kq, vq)
            attend_over = KVCache(new_cache.dequant_k(), new_cache.dequant_v(),
                                  new_cache.length)
        else:
            new_cache = attend_over = _append(cache, k, v)
        o = decode_attention(q, attend_over, n_kv=n_kv, window=window,
                             attn_softcap=attn_softcap)
    else:
        if isinstance(cache, QuantKVCache):
            raise NotImplementedError(
                "prefill into a QuantKVCache is unsupported: prefill "
                "full-precision caches and quantize at the slot-pool join "
                "(serve.cache.scatter_slots)"
            )
        o = blockwise_attention(
            q, k, v, causal=causal, window=window, attn_softcap=attn_softcap,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
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
