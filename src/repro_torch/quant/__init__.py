"""Mixed precision of the port: quantizers, the int8 O-POPE GEMMs (K2, K5)
with their plain versions, the q8 backend functions and precision policies.

The port of :mod:`repro.quant`. :mod:`repro_torch.kernels.ops` registers
the backends ``torch_q8`` and ``cuda_q8``; a :class:`PrecisionPolicy` passed
as ``backend=`` to the model entry points routes each layer role to one of
them. :class:`QuantKVCache` holds the serving pool's narrow K/V lanes.
"""

from .kvcache import (
    DEFAULT_KV_MARGIN,
    QuantKVCache,
    adopt_scale_floor,
    kv_bytes_per_slot,
    quantize_kv,
    quantize_kv_rows,
)
from .opope_q8 import (
    MAX_K,
    opope_gemm_q8,
    opope_gemm_q8_grouped,
    opope_gemm_q8_grouped_plain,
    opope_gemm_q8_plain,
)
from .policy import ROLES, PrecisionPolicy, mlp_q8_policy
from .quantize import (
    FORMATS,
    QuantFormat,
    QuantizedTensor,
    amax_scale,
    calibrate_scale,
    dequantize,
    format_of,
    quantize,
    quantize_with_scale,
)

__all__ = [
    "FORMATS",
    "QuantFormat",
    "QuantizedTensor",
    "amax_scale",
    "calibrate_scale",
    "dequantize",
    "format_of",
    "quantize",
    "quantize_with_scale",
    "MAX_K",
    "opope_gemm_q8",
    "opope_gemm_q8_plain",
    "opope_gemm_q8_grouped",
    "opope_gemm_q8_grouped_plain",
    "PrecisionPolicy",
    "mlp_q8_policy",
    "ROLES",
    "QuantKVCache",
    "quantize_kv",
    "quantize_kv_rows",
    "adopt_scale_floor",
    "kv_bytes_per_slot",
    "DEFAULT_KV_MARGIN",
]
