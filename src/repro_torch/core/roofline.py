"""Roofline constants and dtype-aware GEMM byte accounting.

The parts of :mod:`repro.core.roofline` that utilization attribution
(:mod:`repro_torch.obs.attr`) needs: :class:`HardwareSpec`,
:func:`dtype_width`, :func:`tensor_bytes`, :func:`gemm_bytes` and
:func:`gemm_intensity`, and :func:`model_flops` for the training loop's
step events. Widths come from the operand's actual dtype — a
torch dtype, a numpy dtype or a name (``"bfloat16"``, ``"torch.int8"``) —
never an assumed word.

:data:`H100_SXM` is the card the port runs on. :data:`TPU_V5E` is the
reference's spec, copied only so that tests can cost the same records with
the same spec in both packages; :func:`spec_for_device` never returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "HardwareSpec",
    "H100_SXM",
    "TPU_V5E",
    "spec_for_device",
    "dtype_width",
    "tensor_bytes",
    "gemm_bytes",
    "gemm_intensity",
    "model_flops",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # FLOP/s per chip (bf16, dense)
    hbm_bw: float  # bytes/s per chip
    ici_link_bw: float  # bytes/s per link to a peer chip


# NVIDIA H100 SXM5 at its 700 W limit: 989 TFLOP/s dense bf16 on the tensor
# cores and 3.35 TB/s of HBM3 (the figures PERF.md's bounds use). The peer
# link is NVLink 4: 900 GB/s a card, both directions together, so 450 GB/s
# each way (NVIDIA H100 Tensor Core GPU datasheet); one card never uses it.
H100_SXM = HardwareSpec(
    name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_link_bw=450e9
)

# The reference's TPU v5e figures (src/repro/core/roofline.py): parity
# tests only. No measurement of the port is costed with them.
TPU_V5E = HardwareSpec(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, ici_link_bw=50e9
)


def spec_for_device(device) -> HardwareSpec:
    """The spec to cost GEMMs on ``device`` against.

    On a CUDA device: :data:`H100_SXM` when ``torch.cuda.get_device_name``
    names an H100 SXM (``"NVIDIA H100 80GB HBM3"``); any other card raises,
    so no other card's run is scored against the wrong constants. On the
    CPU: :data:`H100_SXM`, the port's target, as the reference scores its
    CPU runs against its own target chip.
    """
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return H100_SXM
    name = torch.cuda.get_device_name(device)
    if "H100" in name and "PCIe" not in name and "NVL" not in name:
        return H100_SXM
    raise RuntimeError(
        f"no roofline spec for {name!r}: the port knows the H100 SXM only"
    )


# Widths for dtype names numpy may not know.
_NAMED_WIDTHS = {
    "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3": 1,
    "float8_e4m3fnuz": 1, "float8_e5m2fnuz": 1,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "float32": 4, "int32": 4, "uint32": 4,
    "float64": 8, "int64": 8, "uint64": 8,
}


def dtype_width(dtype) -> int:
    """Bytes per element of ``dtype`` (a torch or numpy dtype, or a name)."""
    itemsize = getattr(dtype, "itemsize", None)
    if itemsize:
        return int(itemsize)
    name = str(getattr(dtype, "name", dtype))
    if name.startswith("torch."):
        name = name[len("torch."):]
    if name in _NAMED_WIDTHS:
        return _NAMED_WIDTHS[name]
    import numpy as np

    return int(np.dtype(name).itemsize)


def tensor_bytes(*arrays) -> int:
    """Total bytes of tensors (or anything with ``shape`` and ``dtype``) at
    their actual dtypes."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        size = 1
        for d in a.shape:
            size *= int(d)
        total += size * dtype_width(a.dtype)
    return total


def gemm_bytes(
    m: int,
    k: int,
    n: int,
    *,
    a_dtype,
    b_dtype=None,
    out_dtype=None,
    c_dtype=None,
    scale_elems: int = 0,
) -> int:
    """Minimal device-memory traffic of one ``[M,K] @ [K,N] (+C) -> [M,N]``
    GEMM: each operand read once, the output written once, each at its own
    width. ``scale_elems`` adds fp32 side-band elements (quantization
    scales — ``M + N`` for the per-row/per-channel q8 backends).
    """
    a_w = dtype_width(a_dtype)
    b_w = dtype_width(b_dtype if b_dtype is not None else a_dtype)
    o_w = dtype_width(out_dtype if out_dtype is not None else a_dtype)
    total = m * k * a_w + k * n * b_w + m * n * o_w
    if c_dtype is not None:
        total += m * n * dtype_width(c_dtype)
    return total + 4 * scale_elems


def gemm_intensity(m: int, k: int, n: int, **dtype_kw) -> float:
    """Arithmetic intensity (FLOPs/byte) of the GEMM at honest widths."""
    return (2.0 * m * k * n) / gemm_bytes(m, k, n, **dtype_kw)


def model_flops(
    n_params: int,
    tokens: int,
    *,
    kind: str = "train",
    n_params_active: Optional[int] = None,
) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference fwd), N = active params.

    For MoE models pass ``n_params_active`` (shared + routed*top_k experts plus
    dense layers); for decode shapes ``tokens`` is the global batch (one token
    per sequence per step).
    """
    n = n_params_active if n_params_active is not None else n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
