"""GEMM entry points of the port: ``matmul`` / ``linear`` / ``grouped_matmul``
over two backends.

The port of the ``matmul``/``linear``/``grouped_matmul`` core of
:mod:`repro.kernels.ops`.

* ``"cuda"`` — the hand-written O-POPE kernels (:func:`.opope_gemm.opope_gemm`,
  and :func:`.opope_grouped.opope_gemm_grouped` for grouped GEMMs), epilogue
  fused into their writeback. ``None``/``"auto"`` resolve to it for tensors
  on the card. Asking for it with CPU tensors raises.
* ``"torch"`` — the plain PyTorch versions (``opope_gemm_plain``,
  ``opope_gemm_grouped_plain``): fp32 product, the same epilogue chain, one
  cast. ``None``/``"auto"`` resolve to it for CPU tensors; on the card it
  runs only when named.

Each backend keeps plain integer counts of the GEMMs it ran: ``calls`` for
2-D ones, ``grouped_calls`` for grouped ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from . import epilogue as _epi
from .opope_gemm import opope_gemm, opope_gemm_plain
from .opope_grouped import opope_gemm_grouped, opope_gemm_grouped_plain

__all__ = [
    "Backend",
    "registered_backends",
    "backend",
    "resolve_backend",
    "reset_counts",
    "matmul",
    "linear",
    "grouped_matmul",
]


@dataclasses.dataclass
class Backend:
    """One GEMM backend: ``fn(a, b, c, out_dtype=, epilogue=,
    epilogue_operands=)`` on 2-D operands, ``grouped_fn`` (the same
    signature) on [G, M, K] @ [G, K, N], the device type it runs on (None for
    any), and its call counts."""

    name: str
    fn: Callable[..., torch.Tensor]
    grouped_fn: Callable[..., torch.Tensor]
    device_type: Optional[str]
    calls: int = 0
    grouped_calls: int = 0


_REGISTRY: Dict[str, Backend] = {
    "cuda": Backend("cuda", opope_gemm, opope_gemm_grouped, "cuda"),
    "torch": Backend("torch", opope_gemm_plain, opope_gemm_grouped_plain, None),
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
        be.grouped_calls = 0


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


def grouped_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    epilogue=None,
) -> torch.Tensor:
    """``O[g] = A[g] @ B[g] (+ C[g])``; a: [G, M, K], b: [G, K, N].

    One launch for a whole family of same-shape GEMMs (the MoE experts).
    ``c`` is ``None``, a full ``[G, M, N]`` preload, or a ``[G, N]``
    per-group bias row broadcast at the accumulator preload. ``epilogue``
    post-ops apply per group to the fp32 accumulator before the single cast;
    their operands are a scalar, an ``[N]`` or ``[G, N]`` row, or a full
    ``[G, M, N]``. A ``c`` passed with an epilogue is folded in as its first
    step (``bias`` for a row, ``residual`` for a full operand). Backends
    resolve as in :func:`matmul`.
    """
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(
            f"grouped_matmul wants a [G, M, K] @ [G, K, N]; got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    out_dtype = out_dtype or a.dtype
    name = resolve_backend(backend, a.device)
    g, m, n = a.shape[0], a.shape[1], b.shape[2]
    steps, raw_ops = _epi.normalize_epilogue(epilogue)
    if steps and c is not None:
        name_c = "bias" if c.ndim == 2 else "residual"
        steps, raw_ops = (name_c,) + steps, (c,) + raw_ops
        c = None
    ep_ops = tuple(
        x.contiguous()
        for x in _epi.canonicalize_operands(
            steps, raw_ops, n=n, m=m, groups=g, device=a.device)
    )
    be = _REGISTRY[name]
    be.grouped_calls += 1
    return be.grouped_fn(
        a.contiguous(), b.contiguous(), None if c is None else c.contiguous(),
        out_dtype=out_dtype, epilogue=steps, epilogue_operands=ep_ops,
    )
