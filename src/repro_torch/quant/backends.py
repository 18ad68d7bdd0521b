"""Quantized GEMM backends of the port: the operand quantizers and the two
q8 backend functions that :mod:`repro_torch.kernels.ops` registers.

The port of :mod:`repro.quant.backends`. One numerics contract: int8 dynamic
symmetric quantization — per-row scales on A, per-output-channel scales on
B (per-(group, row) and per-(group, column) for grouped GEMMs) — exact
int32 accumulation, the scales and the optional C applied in fp32 at the
accumulator, the epilogue chain, one cast.

* ``torch_q8`` — the plain versions (:func:`.opope_gemm_q8.opope_gemm_q8_plain`
  and its grouped twin), bitwise against the reference's ``xla_q8``.
* ``cuda_q8`` — the hand-written kernels K2 and K5.

Both quantize the weight operand B on every call, as the reference does.
An A operand that is already quantized (anything with ``.q``/``.scale``, the
output of an upstream ``requant_int8`` epilogue) skips its quantization.
The reference's fallback chains are not ported: a backend launches its
kernel or raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .opope_q8 import (
    opope_gemm_q8,
    opope_gemm_q8_grouped,
    opope_gemm_q8_grouped_plain,
    opope_gemm_q8_plain,
)
from .quantize import QuantizedTensor, quantize

__all__ = [
    "quantize_operands",
    "a_values_scale",
    "quantize_grouped_operands",
    "torch_q8",
    "torch_q8_grouped",
    "cuda_q8",
    "cuda_q8_grouped",
]


def quantize_operands(a: torch.Tensor, b: torch.Tensor) -> Tuple[QuantizedTensor, QuantizedTensor]:
    """Per-row (A, scale [M, 1]) and per-output-channel (B, scale [1, N])
    int8 quantization: the finest granularity that still factors out of the
    GEMM, ``C[m,n] = sa[m] * sb[n] * sum_k qa[m,k] * qb[k,n]``."""
    return quantize(a, "int8", axis=0), quantize(b, "int8", axis=1)


def a_values_scale(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (int8 values, [M, 1] fp32 scale) of the A operand. A
    pre-quantized A is consumed as it is, its per-tensor (or per-row) scale
    broadcast to [M, 1]; a tensor is quantized per row."""
    if hasattr(a, "q") and hasattr(a, "scale"):
        q = a.q
        s = torch.as_tensor(a.scale, dtype=torch.float32, device=q.device)
        s = s.reshape(-1, 1) if s.numel() == q.shape[0] else s.reshape(1, 1)
        return q, s.expand(q.shape[0], 1).contiguous()
    aq = quantize(a, "int8", axis=0)
    return aq.q, aq.scale


def quantize_grouped_operands(a: torch.Tensor, b: torch.Tensor
                              ) -> Tuple[QuantizedTensor, QuantizedTensor]:
    """Per-group quantization of a grouped pair: A [G, M, K] per (group,
    row), scale [G, M, 1]; B [G, K, N] per (group, column), scale [G, 1, N].
    No amax is shared across groups."""
    return quantize(a, "int8", axis=(0, 1)), quantize(b, "int8", axis=(0, 2))


def _dense(gemm: Callable) -> Callable:
    def run(a, b, c=None, *, out_dtype=None, epilogue=(), epilogue_operands=()):
        a_q, a_scale = a_values_scale(a)
        bq = quantize(b, "int8", axis=1)
        return gemm(a_q, a_scale, bq.q, bq.scale, c, out_dtype=out_dtype,
                    epilogue=epilogue, epilogue_operands=epilogue_operands)
    return run


def _grouped(gemm: Callable) -> Callable:
    def run(a, b, c=None, *, out_dtype=None, epilogue=(), epilogue_operands=()):
        aq, bq = quantize_grouped_operands(a, b)
        return gemm(aq.q, aq.scale, bq.q, bq.scale, c, out_dtype=out_dtype,
                    epilogue=epilogue, epilogue_operands=epilogue_operands)
    return run


torch_q8 = _dense(opope_gemm_q8_plain)
torch_q8_grouped = _grouped(opope_gemm_q8_grouped_plain)
cuda_q8 = _dense(opope_gemm_q8)
cuda_q8_grouped = _grouped(opope_gemm_q8_grouped)
