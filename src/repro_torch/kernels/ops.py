"""GEMM entry points of the port: ``matmul`` / ``linear`` over two backends.

The port of the ``matmul``/``linear`` core of :mod:`repro.kernels.ops`.

* ``"cuda"`` — the hand-written O-POPE kernel (:func:`.opope_gemm.opope_gemm`),
  epilogue fused into its writeback. ``None``/``"auto"`` resolve to it for
  tensors on the card. Asking for it with CPU tensors raises.
* ``"torch"`` — the plain PyTorch version (:func:`.opope_gemm.opope_gemm_plain`):
  fp32 product, the same epilogue chain, one cast. ``None``/``"auto"``
  resolve to it for CPU tensors; on the card it runs only when named.

Each backend keeps a plain integer count of the GEMMs it ran (``calls``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from . import epilogue as _epi
from .opope_gemm import opope_gemm, opope_gemm_plain

__all__ = [
    "Backend",
    "registered_backends",
    "backend",
    "resolve_backend",
    "reset_counts",
    "matmul",
    "linear",
]


@dataclasses.dataclass
class Backend:
    """One GEMM backend: ``fn(a, b, c, out_dtype=, epilogue=,
    epilogue_operands=)`` on 2-D operands, the device type it runs on (None
    for any), and its call count."""

    name: str
    fn: Callable[..., torch.Tensor]
    device_type: Optional[str]
    calls: int = 0


_REGISTRY: Dict[str, Backend] = {
    "cuda": Backend("cuda", opope_gemm, "cuda"),
    "torch": Backend("torch", opope_gemm_plain, None),
}


def registered_backends() -> List[str]:
    return list(_REGISTRY)


def backend(name: str) -> Backend:
    """The registered backend ``name`` (for its ``calls`` count)."""
    return _REGISTRY[name]


def reset_counts() -> None:
    """Set every backend's call count to zero."""
    for be in _REGISTRY.values():
        be.calls = 0


def resolve_backend(name: Optional[str], device: torch.device) -> str:
    """Resolve a backend request for tensors on ``device``: ``None``/``"auto"``
    pick ``"cuda"`` on the card and ``"torch"`` on the CPU; a named backend
    that cannot take tensors on ``device`` raises (there is no fallback)."""
    device = torch.device(device)
    if name in (None, "auto"):
        return "cuda" if device.type == "cuda" else "torch"
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(
            f"unknown matmul backend {name!r}; registered: {registered_backends()}"
        )
    if be.device_type is not None and device.type != be.device_type:
        raise ValueError(
            f"matmul backend {name!r} runs on {be.device_type} tensors, "
            f"got tensors on {device}"
        )
    return name


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    epilogue=None,
) -> torch.Tensor:
    """``a @ b (+ c)`` with O-POPE semantics; a: [..., K], b: [K, N].

    Leading dims of ``a`` flatten into M. ``c`` is a full operand matching
    ``a``'s leading dims x N, or an ``[N]`` bias row preloaded into the
    accumulator. ``epilogue`` is a pipeline of registered post-ops
    (:mod:`.epilogue`) run on the fp32 accumulator before the single cast;
    a ``c`` passed with an epilogue is folded in as its first step (``bias``
    for a row, ``residual`` for a full operand). ``out_dtype`` defaults to
    ``a.dtype``.
    """
    out_dtype = out_dtype or a.dtype
    name = resolve_backend(backend, a.device)
    batch_shape = tuple(a.shape[:-1])
    m = math.prod(batch_shape)
    n = b.shape[-1]
    steps, raw_ops = _epi.normalize_epilogue(epilogue)
    if steps and c is not None:
        # C enters the accumulator linearly: preload-then-epilogue equals
        # bias/residual-step-then-rest.
        if c.ndim == 1:
            steps, raw_ops = ("bias",) + steps, (c,) + raw_ops
        else:
            steps, raw_ops = ("residual",) + steps, (c,) + raw_ops
        c = None
    ep_ops = tuple(
        x.contiguous()
        for x in _epi.canonicalize_operands(steps, raw_ops, n=n, m=m, device=a.device)
    )
    if c is not None:
        c = (c if c.ndim == 1 else c.reshape(m, n)).contiguous()
    be = _REGISTRY[name]
    be.calls += 1
    out = be.fn(
        a.reshape(m, a.shape[-1]).contiguous(), b.contiguous(), c,
        out_dtype=out_dtype, epilogue=steps, epilogue_operands=ep_ops,
    )
    return out.reshape(*batch_shape, n)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    epilogue=None,
) -> torch.Tensor:
    """Linear layer on the O-POPE path: the [N] bias rides the C preload."""
    return matmul(x, w, bias, backend=backend, out_dtype=out_dtype, epilogue=epilogue)
