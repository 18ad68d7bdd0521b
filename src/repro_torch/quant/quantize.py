"""Quantizers: int8 and fp8 (e4m3 / e5m2), per-tensor or per-channel.

The port of :mod:`repro.quant.quantize`, value for value:

* **Formats** — ``int8`` (symmetric, qmax 127), ``fp8_e4m3`` (max 448) and
  ``fp8_e5m2`` (max 57344), stored in ``torch.int8``,
  ``torch.float8_e4m3fn`` and ``torch.float8_e5m2``; arithmetic on fp8
  values happens after widening to fp32.
* **Scales** — fp32, per-tensor (a 0-d tensor) or per-channel (``axis=``
  keeps that axis, e.g. ``axis=1`` on a ``[K, N]`` weight gives a ``[1, N]``
  scale that broadcasts in the dequant; a tuple keeps several axes).
* **Calibration** — :func:`calibrate_scale` folds an amax over sample
  batches into a fixed scale.

Numerics that must match the reference to the bit: ``x.float() / scale`` (a
true division, never a reciprocal multiply), round half to even
(``torch.round``) before the clip to ``±qmax``, and an amax floor of
``1e-12`` so an all-zero tensor quantizes to zeros, not NaNs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Tuple, Union

import torch

__all__ = [
    "QuantFormat",
    "FORMATS",
    "QuantizedTensor",
    "format_of",
    "quantize",
    "quantize_with_scale",
    "dequantize",
    "amax_scale",
    "calibrate_scale",
]

Axes = Union[int, Tuple[int, ...], None]

_TINY = 1e-12  # amax floor: all-zero tensors quantize to zeros, not NaNs


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    """One storage format: name, storage dtype, and largest representable
    magnitude (the value an amax maps onto)."""

    name: str
    dtype: torch.dtype
    qmax: float
    integer: bool

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.integer:
            return torch.clamp(torch.round(x), -self.qmax, self.qmax).to(self.dtype)
        return torch.clamp(x, -self.qmax, self.qmax).to(self.dtype)


FORMATS = {
    "int8": QuantFormat("int8", torch.int8, 127.0, True),
    "fp8_e4m3": QuantFormat("fp8_e4m3", torch.float8_e4m3fn, 448.0, False),
    "fp8_e5m2": QuantFormat("fp8_e5m2", torch.float8_e5m2, 57344.0, False),
}

_BY_DTYPE = {f.dtype: f for f in FORMATS.values()}


def format_of(fmt_or_dtype: Union[str, torch.dtype, QuantFormat]) -> QuantFormat:
    """Resolve a format name, storage dtype, or QuantFormat to a QuantFormat."""
    if isinstance(fmt_or_dtype, QuantFormat):
        return fmt_or_dtype
    if isinstance(fmt_or_dtype, str) and fmt_or_dtype in FORMATS:
        return FORMATS[fmt_or_dtype]
    f = _BY_DTYPE.get(fmt_or_dtype) if isinstance(fmt_or_dtype, torch.dtype) else None
    if f is None:
        raise ValueError(
            f"unknown quant format {fmt_or_dtype!r}; known: {sorted(FORMATS)}"
        )
    return f


class QuantizedTensor(NamedTuple):
    """Narrow values + fp32 scale. ``dequant = q.float() * scale``.

    ``scale`` is 0-d (per-tensor) or keepdims-shaped (per-channel), so it
    broadcasts against ``q``. The format follows from ``q.dtype``."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def fmt(self) -> QuantFormat:
        return format_of(self.q.dtype)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


def _reduce_dims(ndim: int, axis: Axes) -> Tuple[int, ...]:
    """The dims to reduce over, given the axis (or axes) to KEEP."""
    keep = {a % ndim for a in ((axis,) if isinstance(axis, int) else axis)}
    return tuple(i for i in range(ndim) if i not in keep)


def _amax(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    xf = x.float().abs()
    if axis is None:
        return xf.amax()
    return xf.amax(dim=_reduce_dims(x.ndim, axis), keepdim=True)


def amax_scale(x: torch.Tensor, fmt: Union[str, QuantFormat] = "int8",
               axis: Axes = None) -> torch.Tensor:
    """Symmetric scale mapping the observed amax onto the format's qmax.

    ``axis=None`` gives a per-tensor 0-d scale; an integer axis keeps that
    axis (per-channel), reducing over the others with keepdims; a tuple keeps
    several (``axis=(0, 1)`` on a ``[G, M, K]`` stack: per-(group, row))."""
    return torch.clamp_min(_amax(x, axis), _TINY) / format_of(fmt).qmax


def quantize_with_scale(x: torch.Tensor, scale, fmt: Union[str, QuantFormat] = "int8"
                        ) -> QuantizedTensor:
    """Quantize with a fixed (e.g. calibrated) scale; out-of-range clips."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return QuantizedTensor(q=format_of(fmt).cast(x.float() / scale), scale=scale)


def quantize(x: torch.Tensor, fmt: Union[str, QuantFormat] = "int8", *,
             axis: Axes = None) -> QuantizedTensor:
    """Dynamic symmetric quantization (scale from this tensor's own amax).
    ``axis`` is the axis (or axes) the scale KEEPS — see :func:`amax_scale`."""
    return quantize_with_scale(x, amax_scale(x, fmt, axis=axis), fmt)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)


def calibrate_scale(batches: Iterable, fmt: Union[str, QuantFormat] = "int8", *,
                    axis: Axes = None, margin: float = 1.0) -> torch.Tensor:
    """Scale from the running amax over sample batches (static quantization).
    ``margin > 1`` leaves headroom for values the calibration set did not
    show, at the cost of ``log2(margin)`` bits of resolution."""
    amax = None
    for x in batches:
        a = _amax(torch.as_tensor(x), axis)
        amax = a if amax is None else torch.maximum(amax, a)
    if amax is None:
        raise ValueError("calibrate_scale: no batches provided")
    return torch.clamp_min(amax * margin, _TINY) / format_of(fmt).qmax
