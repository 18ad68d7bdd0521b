"""Grouped O-POPE GEMM (K4): the hand-written CUDA kernel and its plain version.

Ports :func:`repro.kernels.opope_grouped.opope_gemm_grouped` (the Pallas TPU
kernel). Both functions here compute ``O[g] = epilogue(A[g] @ B[g] (+ C[g]))``
for every group ``g`` of same-shape GEMMs (the MoE experts): an fp32
accumulator per group, ``C`` a full ``[G, M, N]`` tile or a ``[G, N]`` row
preloaded into it, the epilogue chain run per group on the fp32 accumulator,
and one cast to ``out_dtype`` at the end.

* :func:`opope_gemm_grouped` launches ``csrc/opope_grouped.cu`` — all groups
  in one launch, the group as a grid axis — for tensors on the card, and
  raises on what the kernel does not take. Given tensors on the CPU it runs
  :func:`opope_gemm_grouped_plain`: the kernel has no CPU form.
  ``opope_gemm_grouped.launches`` counts kernel launches.
* :func:`opope_gemm_grouped_plain` is ``torch.bmm`` in fp32 (TF32 off) plus
  C, the same epilogue chain, one cast: the CPU path and the reference the
  kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build as _build
from . import epilogue as _ep
from .opope_gemm import (
    _DTYPE_CODES,
    _Epilogue,
    _check_launch_operands,
    _epilogue_struct,
    full_fp32,
)

__all__ = ["opope_gemm_grouped", "opope_gemm_grouped_plain"]


def _launcher():
    lib = _build.load("opope_grouped")
    fn = lib.opope_grouped_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p, i, i, i, i, i,
                       ctypes.POINTER(_Epilogue), p]
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands):
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"bad grouped GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    g, m, _ = a.shape
    n = b.shape[2]
    if c is not None and tuple(c.shape) not in ((g, n), (g, m, n)):
        raise ValueError(f"C preload shape {tuple(c.shape)} != {(g, n)} or {(g, m, n)}")
    if out_dtype == torch.int8 and (not epilogue or epilogue[-1] != "requant_int8"):
        raise ValueError("int8 output needs an epilogue chain ending in requant_int8")
    n_ops = sum(1 for s in epilogue if _ep.op_kind(s) != "none")
    if n_ops != len(epilogue_operands):
        raise ValueError(
            f"epilogue {epilogue} takes {n_ops} operands, got {len(epilogue_operands)}"
        )
    return g, m, n


def opope_gemm_grouped_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """Plain PyTorch ``epilogue(A[g] @ B[g] (+ C[g]))``: ``torch.bmm`` in
    fp32 (TF32 off), C added in fp32, the epilogue chain in fp32, one cast."""
    out_dtype = out_dtype or a.dtype
    _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    with full_fp32():
        acc = torch.bmm(a.float(), b.float())
    if c is not None:
        acc = acc + (c.float()[:, None, :] if c.ndim == 2 else c.float())
    acc = _ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
    return acc.to(out_dtype)


def opope_gemm_grouped(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """``O[g] = epilogue(A[g] @ B[g] (+ C[g]))`` on the hand-written CUDA
    kernel, every group in one launch.

    a: [G, M, K], b: [G, K, N], both bf16 or both fp32, contiguous.
    c: [G, M, N] or [G, N]. ``epilogue_operands`` carries one canonical
    operand per operand-taking step (scalar ``(1,1,1)``, row ``(G,1,N)``,
    full ``(G,M,N)``). ``out_dtype`` is bf16, fp16 or fp32, or int8 behind
    ``requant_int8``; it defaults to ``a.dtype``.
    """
    if a.device.type == "cpu":
        return opope_gemm_grouped_plain(
            a, b, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    if a.device.type != "cuda":
        raise ValueError(f"opope_gemm_grouped runs on cuda tensors, got {a.device}")
    out_dtype = out_dtype or a.dtype
    g, m, n = _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    k = a.shape[2]
    _check_launch_operands(
        "opope_gemm_grouped", a, b, c, out_dtype, epilogue, epilogue_operands
    )
    ep = _epilogue_struct(epilogue, epilogue_operands,
                          {"scalar": (1, 1, 1), "row": (g, 1, n), "full": (g, m, n)})

    out = torch.empty((g, m, n), dtype=out_dtype, device=a.device)
    if g == 0 or m == 0 or n == 0:
        return out
    # Whole 16-byte vectors stay inside a row, and every group's base stays
    # aligned, when K (for A) or N (for B) is a multiple of the vector.
    vec = 16 // a.element_size()
    vec_a = k % vec == 0 and a.data_ptr() % 16 == 0
    vec_b = n % vec == 0 and b.data_ptr() % 16 == 0
    c_kind = 0 if c is None else (2 if c.ndim == 2 else 3)
    launch = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, n, k,
            _DTYPE_CODES[a.dtype],
            None if c is None else c.data_ptr(), c_kind,
            0 if c is None else _DTYPE_CODES[c.dtype],
            _DTYPE_CODES[out_dtype], int(vec_a), int(vec_b),
            ctypes.byref(ep), stream,
        )
    if rc != 0:
        raise RuntimeError(f"opope_gemm_grouped kernel launch failed: CUDA error {rc}")
    opope_gemm_grouped.launches += 1
    return out


opope_gemm_grouped.launches = 0
