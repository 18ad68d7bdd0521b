"""The port's O-POPE kernels: hand-written CUDA kernels for Hopper, each with
its plain PyTorch version, and plain oracles.

The port of :mod:`repro.kernels`, with its public names:

* ``opope_gemm``          — the O-POPE GEMM (K1), epilogue fused;
* ``opope_gemm_grouped``  — G same-shape GEMMs in one launch (K4);
* ``opope_attention``, ``opope_attention_bhsd`` — flash attention with the
                            same accumulator-resident structure (K3);
* ``opope_chunked_scan``  — the state-resident linear scan (K6);
* ``ref``                 — plain oracles for all of the above;
* ``ops``                 — the backend-routed ``matmul``/``grouped_matmul``
                            every model layer calls.

As in the reference, ``repro_torch.kernels.opope_gemm`` and
``repro_torch.kernels.opope_attention`` name the functions; their modules
are reached by ``from repro_torch.kernels.opope_gemm import ...``. ``ops``
is imported on first use: it registers the int8 backends of
:mod:`repro_torch.quant`, which itself imports from this package. Importing
this package builds nothing: each kernel compiles on its first launch.
"""

import importlib

from . import ref
from .opope_attention import opope_attention, opope_attention_bhsd
from .opope_gemm import opope_gemm
from .opope_grouped import opope_gemm_grouped
from .opope_scan import opope_chunked_scan

__all__ = [
    "ops",
    "ref",
    "opope_gemm",
    "opope_gemm_grouped",
    "opope_attention",
    "opope_attention_bhsd",
    "opope_chunked_scan",
]


def __getattr__(name):
    if name == "ops":
        return importlib.import_module(f"{__name__}.ops")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
