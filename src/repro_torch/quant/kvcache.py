"""Quantized K/V lanes for the slot-pooled serving cache.

The port of :mod:`repro.quant.kvcache`. Per slot the pool holds
``2 * max_len * n_kv * head_dim`` K/V elements per attention layer; one-byte
lanes (int8 or an fp8 format) halve that against bf16 lanes, so the same
device memory admits about twice the concurrent requests.

Layout (one :class:`QuantKVCache` per layer, as :class:`KVCache`):

* ``k`` / ``v`` — narrow values ``[B, S_max, n_kv * head_dim]``,
* ``k_scale`` / ``v_scale`` — fp32 per-slot, per-head scales ``[B, n_kv]``,
  calibrated once per request at join time from its prefilled K/V (per-head
  amax over the prompt span, with a margin for later decode tokens), then
  fixed for the request's lifetime,
* ``length`` — the fill point, as in ``KVCache``.

The decode step dequantizes inside the attention layer; nothing outside the
step sees wide K/V. Numerics that must match the reference to the bit:
``x / scale`` (a true division), round half to even, and a floor adopted
outright while the values fit its range (:func:`quantize_kv_rows`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .quantize import QuantFormat, format_of

__all__ = [
    "QuantKVCache",
    "quantize_kv",
    "quantize_kv_rows",
    "adopt_scale_floor",
    "kv_bytes_per_slot",
    "DEFAULT_KV_MARGIN",
]

# Join-time calibration headroom: decode-time K/V can exceed the prompt-span
# amax; 1.25x costs about a third of a bit and makes clipping rare.
DEFAULT_KV_MARGIN = 1.25

_TINY = 1e-12


@dataclasses.dataclass
class QuantKVCache:
    """Narrow-lane decode cache with per-slot, per-head fp32 scales: a
    drop-in for ``KVCache`` (same ``length`` contract, same leading axes)."""

    k: torch.Tensor  # [B, S_max, n_kv * head_dim], narrow dtype
    v: torch.Tensor
    k_scale: torch.Tensor  # [B, n_kv] fp32
    v_scale: torch.Tensor
    length: Union[int, torch.Tensor] = 0

    @property
    def n_kv(self) -> int:
        return self.k_scale.shape[-1]

    @property
    def fmt(self) -> QuantFormat:
        return format_of(self.k.dtype)

    @staticmethod
    def zeros(
        batch: int, max_len: int, n_kv: int, head_dim: int,
        fmt: Union[str, QuantFormat] = "int8", device=None,
    ) -> "QuantKVCache":
        f = format_of(fmt)
        shape = (batch, max_len, n_kv * head_dim)
        return QuantKVCache(
            k=torch.zeros(shape, dtype=f.dtype, device=device),
            v=torch.zeros(shape, dtype=f.dtype, device=device),
            k_scale=torch.ones((batch, n_kv), dtype=torch.float32, device=device),
            v_scale=torch.ones((batch, n_kv), dtype=torch.float32, device=device),
            length=0,
        )

    def dequant_k(self, dtype=torch.float32) -> torch.Tensor:
        return _dequant(self.k, self.k_scale, dtype)

    def dequant_v(self, dtype=torch.float32) -> torch.Tensor:
        return _dequant(self.v, self.v_scale, dtype)

    def quantize_rows(self, kf: torch.Tensor, vf: torch.Tensor):
        """Quantize one appended token per row (``[B, n_kv * head_dim]``)
        through this cache's fixed per-slot scales; values past the
        calibrated range clip."""
        return (
            _quant_rows(kf, self.k_scale, self.fmt),
            _quant_rows(vf, self.v_scale, self.fmt),
        )


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    *lead, s, f = q.shape
    n_kv = scale.shape[-1]
    x = q.reshape(*lead, s, n_kv, f // n_kv).float()
    x = x * scale[..., None, :, None]
    return x.reshape(*lead, s, f).to(dtype)


def _quant_rows(x: torch.Tensor, scale: torch.Tensor, fmt: QuantFormat) -> torch.Tensor:
    *lead, f = x.shape
    n_kv = scale.shape[-1]
    xs = x.reshape(*lead, n_kv, f // n_kv).float() / scale[..., :, None]
    return fmt.cast(xs).reshape(*lead, f)


def quantize_kv_rows(
    k: torch.Tensor,
    v: torch.Tensor,
    n_kv: int,
    *,
    fmt: Union[str, torch.dtype, QuantFormat] = "int8",
    margin: float = DEFAULT_KV_MARGIN,
    k_scale_floor: Optional[torch.Tensor] = None,
    v_scale_floor: Optional[torch.Tensor] = None,
):
    """Calibrate per-(row, head) scales from full-precision K/V rows and
    quantize them. k/v: ``[..., S, n_kv * head_dim]``; the amax reduces over
    positions and the head dim, keeping heads.

    ``k_scale_floor`` / ``v_scale_floor`` (``[..., n_kv]``) are the prefix
    cache's scale adoption: a cached prefix quantized at scale ``s0`` and
    dequantized into a new request's span is quantized again at ``s0``
    whenever the row's amax fits ``s0``'s range (``amax <= qmax * s0``; the
    floor already carries its calibration margin), so
    ``cast(q * s0 / s0) == q`` bit for bit. Otherwise the row recalibrates
    with the margin, never finer than the floor.

    Returns ``(k_q, v_q, k_scale, v_scale)``, the scales ``[..., n_kv]``.
    """
    f = format_of(fmt)

    def one(x, floor):
        *lead, s, fused = x.shape
        xh = x.reshape(*lead, s, n_kv, fused // n_kv).float()
        amax = xh.abs().amax(dim=(-3, -1))  # [..., n_kv]
        scale = torch.clamp_min(amax * margin, _TINY) / f.qmax
        if floor is not None:
            fl = floor.float()
            # Adopt the floor outright while the values fit its range:
            # applying the margin again to a round-tripped amax would move
            # the scale one rounding step past the floor.
            scale = torch.where(amax <= f.qmax * fl, fl, torch.maximum(scale, fl))
        q = f.cast(xh / scale[..., None, :, None]).reshape(*lead, s, fused)
        return q, scale

    k_q, k_scale = one(k, k_scale_floor)
    v_q, v_scale = one(v, v_scale_floor)
    return k_q, v_q, k_scale, v_scale


def adopt_scale_floor(prefix_scales: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Broadcast a cached prefix's per-head scales ``[..., n_kv]`` to the
    per-row floor layout ``[..., n_rows, n_kv]`` that :func:`quantize_kv_rows`
    takes for a join batch (rows without a prefix pass 0, a no-op floor)."""
    s = prefix_scales.float()
    return s.unsqueeze(-2).expand(*s.shape[:-1], n_rows, s.shape[-1])


def quantize_kv(
    cache,
    n_kv: Optional[int] = None,
    *,
    fmt: Union[str, QuantFormat] = "int8",
    margin: float = DEFAULT_KV_MARGIN,
) -> QuantKVCache:
    """Quantize a full-precision cache (``.k``/``.v``/``.length``) into a
    :class:`QuantKVCache` with freshly calibrated per-row, per-head scales;
    ``n_kv`` defaults to one head (one scale per row)."""
    k_q, v_q, k_scale, v_scale = quantize_kv_rows(
        cache.k, cache.v, n_kv if n_kv is not None else 1, fmt=fmt, margin=margin
    )
    return QuantKVCache(k=k_q, v=v_q, k_scale=k_scale, v_scale=v_scale,
                        length=cache.length)


def kv_bytes_per_slot(caches) -> float:
    """Mean K/V bytes held per slot over a pool's per-layer caches
    ``[n_slots, S_max, fused]``: value lanes plus the scale sidecars of
    quantized caches. Entries without ``k``/``v`` are skipped; a pool with
    none reports 0.0."""
    total = 0
    n_slots = None
    for c in caches:
        if isinstance(c, QuantKVCache):
            arrs = (c.k, c.v, c.k_scale, c.v_scale)
        elif hasattr(c, "k") and hasattr(c, "v"):
            arrs = (c.k, c.v)
        else:
            continue
        n_slots = c.k.shape[0]
        total += sum(a.numel() * a.element_size() for a in arrs)
    if not n_slots:
        return 0.0
    return total / n_slots
