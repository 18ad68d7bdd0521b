"""Plain PyTorch oracles for every kernel of the port.

The port of :mod:`repro.kernels.ref`: the same four functions with the same
signatures and contracts, fp32 throughout. They run on any device and serve
the tests as a second, independent statement of what each kernel computes;
the kernels' plain versions (``opope_gemm_plain``, ``opope_attention_plain``
...) stay beside the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from .opope_gemm import full_fp32

__all__ = [
    "reference_matmul",
    "reference_grouped_matmul",
    "reference_attention",
    "reference_chunked_scan",
    "fma_f32",
]


def reference_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Oracle for ``opope_gemm``: multiply in fp32 (never TF32), accumulate
    in fp32, optionally add C (``[M, N]`` or an ``[N]`` row), cast once."""
    out_dtype = out_dtype or a.dtype
    with full_fp32():
        acc = torch.matmul(a.float(), b.float())
    if c is not None:
        acc = acc + c.float()
    return acc.to(out_dtype)


def reference_grouped_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Oracle for ``opope_gemm_grouped``: ``O[g] = A[g] @ B[g] (+ C[g])``
    with the per-group contract of :func:`reference_matmul`; C is a full
    ``[G, M, N]`` tile or a ``[G, N]`` row. a: [G, M, K], b: [G, K, N]."""
    out_dtype = out_dtype or a.dtype
    with full_fp32():
        acc = torch.bmm(a.float(), b.float())
    if c is not None:
        cf = c.float()
        acc = acc + (cf[:, None, :] if c.ndim == 2 else cf)
    return acc.to(out_dtype)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Oracle for ``opope_attention``: q [S, D], k/v [T, D] (leading batch
    dims broadcast). fp32 scores, softmax and accumulation; the causal mask
    is aligned to the end of the keys and masks with ``-inf``, so a query
    row with no valid key gives NaN, as the reference's oracle does."""
    out_dtype = out_dtype or q.dtype
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    with full_fp32():
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, tk = q.shape[-2], k.shape[-2]
        mask = torch.ones((sq, tk), dtype=torch.bool, device=q.device).tril(tk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    with full_fp32():
        o = torch.matmul(p, v.float())
    return o.to(out_dtype)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on fp32 tensors, rounded once to fp32 (a fused
    multiply-add, as ``__fmaf_rn`` on the card and as XLA contracts
    ``a * b + c`` on the CPU).

    The product of two fp32 values is exact in fp64. The fp64 sum is made
    round-to-odd (an inexact sum with an even last bit moves one fp64 ulp
    toward the exact value, found by TwoSum); a round-to-odd result with 53
    bits rounds to the 24 bits of fp32 exactly as the exact value would, so
    the result is the correctly rounded FMA, bit for bit."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def reference_chunked_scan(
    decay: torch.Tensor, update: torch.Tensor, init: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Oracle for the state-resident chunked linear scan:
    ``h[t] = decay[t] * h[t-1] + update[t]`` over the leading axis in fp32,
    every state returned; ``h[-1]`` is ``init`` (broadcast) or zeros.
    decay/update: [S, ...] broadcastable. Each step rounds once
    (:func:`fma_f32`), as the reference's scan does on the CPU."""
    decay = decay.float()
    update = update.float()
    h = (torch.zeros_like(update[0]) if init is None
         else torch.broadcast_to(init.float(), update[0].shape).clone())
    hs = []
    for t in range(update.shape[0]):
        h = fma_f32(torch.broadcast_to(decay[t], h.shape), h, update[t])
        hs.append(h)
    return torch.stack(hs) if hs else torch.empty_like(update)
