"""GEMM entry points of the port: ``matmul`` / ``linear`` / ``grouped_matmul``
over four backends in two numerics families.

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
* ``"cuda_q8"`` and ``"torch_q8"`` — family ``"q8"``
  (:mod:`repro_torch.quant.backends`): int8 operands quantized per row of A
  and per column of B, exact int32 products, dequant and epilogue at the
  writeback; ``cuda_q8`` on the hand-written kernels K2 and K5,
  ``torch_q8`` on their plain versions. ``"q8"`` resolves to ``cuda_q8``
  for tensors on the card and to ``torch_q8`` on the CPU.

A backend that cannot take the tensors it is given raises: there are no
fallback chains. Each backend keeps plain integer counts of the GEMMs it
ran: ``calls`` for 2-D ones, ``grouped_calls`` for grouped ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from . import epilogue as _epi
from .opope_gemm import opope_gemm, opope_gemm_plain
from .opope_grouped import opope_gemm_grouped, opope_gemm_grouped_plain
from repro_torch.quant import backends as _q8
from repro_torch.quant.quantize import QuantizedTensor

__all__ = [
    "Backend",
    "registered_backends",
    "backend",
    "resolve_backend",
    "family_of",
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
    any), its numerics family (``"fp"``/``"q8"``), the full-precision
    backend its gradients will run on (``grad_backend``, for quantized
    members), and its call counts."""

    name: str
    fn: Callable[..., torch.Tensor]
    grouped_fn: Callable[..., torch.Tensor]
    device_type: Optional[str]
    family: str = "fp"
    grad_backend: Optional[str] = None
    calls: int = 0
    grouped_calls: int = 0


_REGISTRY: Dict[str, Backend] = {
    "cuda": Backend("cuda", opope_gemm, opope_gemm_grouped, "cuda"),
    "torch": Backend("torch", opope_gemm_plain, opope_gemm_grouped_plain, None),
    "cuda_q8": Backend("cuda_q8", _q8.cuda_q8, _q8.cuda_q8_grouped, "cuda",
                       family="q8", grad_backend="cuda"),
    "torch_q8": Backend("torch_q8", _q8.torch_q8, _q8.torch_q8_grouped, None,
                        family="q8", grad_backend="torch"),
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
    pick ``"cuda"`` on the card and ``"torch"`` on the CPU, ``"q8"`` picks
    ``"cuda_q8"`` or ``"torch_q8"`` the same way; a named backend that cannot
    take tensors on ``device`` raises (there is no fallback)."""
    device = torch.device(device)
    if name in (None, "auto"):
        return "cuda" if device.type == "cuda" else "torch"
    if name == "q8":
        return "cuda_q8" if device.type == "cuda" else "torch_q8"
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


def family_of(name: str) -> str:
    """Numerics family (``"fp"``, ``"q8"``) of a registered backend."""
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(
            f"unknown matmul backend {name!r}; registered: {registered_backends()}"
        )
    return be.family


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

    ``a`` may also be a pre-quantized activation (anything with ``.q`` /
    ``.scale``, e.g. a ``QuantizedTensor``, the output of an upstream
    ``requant_int8`` epilogue) on a q8-family backend, which then consumes
    its int8 values as they are; ``out_dtype`` then defaults to fp32.
    """
    pre_q = hasattr(a, "q") and hasattr(a, "scale")
    arr = a.q if pre_q else a
    out_dtype = out_dtype or (torch.float32 if pre_q else arr.dtype)
    name = resolve_backend(backend, arr.device)
    batch_shape = tuple(arr.shape[:-1])
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
        for x in _epi.canonicalize_operands(steps, raw_ops, n=n, m=m, device=arr.device)
    )
    if c is not None:
        c = (c if c.ndim == 1 else c.reshape(m, n)).contiguous()
    be = _REGISTRY[name]
    a2 = arr.reshape(m, arr.shape[-1]).contiguous()
    if pre_q:
        if be.family != "q8":
            raise ValueError(
                f"pre-quantized activations need a q8-family backend; "
                f"{name!r} is family {be.family!r}"
            )
        scale = torch.as_tensor(a.scale, dtype=torch.float32, device=arr.device)
        a2 = QuantizedTensor(
            a2, scale.reshape(m, 1) if scale.numel() == m else scale.reshape(1, 1))
    be.calls += 1
    out = be.fn(
        a2, b.contiguous(), c,
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
    resolve as in :func:`matmul`; a q8-family backend quantizes per group
    (A per (group, row), B per (group, column)).
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
