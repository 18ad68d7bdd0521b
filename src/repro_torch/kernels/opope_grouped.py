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
  ``opope_gemm_grouped.launches`` counts kernel launches, and
  ``opope_gemm_grouped.launches_by_route`` splits them by route.
* :func:`_plan` chooses the route before the launch, from the operands
  alone: ``"sm90"`` (a TMA ring + ``wgmma`` over rank-3 per-group tensor
  maps, K1's sm90 body with the group as the third box coordinate, K never
  split) for bf16 or fp16 operands of one dtype whose row strides and
  bases TMA can describe, else ``"tile"`` (the 64x64 tile body shared with
  K1; fp32, the 8-bit floats and mixed pairs always go there). The dtype
  rule (inputs, compute type, out dtype, the final cast) is K1's
  (:mod:`.opope_gemm`).
* :func:`opope_gemm_grouped_plain` is ``torch.bmm`` in fp32 (TF32 off) plus
  C, the same epilogue chain, one cast by K1's rule: the CPU path and the
  reference the kernel is held against on the card.

The tuning knob is the tile alone (K never splits): :func:`candidate_plans`
and :func:`validate_plan` as K1's, and a ``plan=`` on
:func:`opope_gemm_grouped` whose tile the launch runs (an illegal one raises).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from . import build as _build
from . import epilogue as _ep
from .opope_gemm import (
    _DTYPE_CODES,
    _Epilogue,
    Plan,
    _SM90_BLOCKS,
    _check_launch_operands,
    _epilogue_struct,
    _tile_vectors,
    _tma_ok,
    _unsplit_plan,
    compute_dtype,
    full_fp32,
    plan_dtype,
)
from .opope_gemm import _validated as _k1_validated

__all__ = ["opope_gemm_grouped", "opope_gemm_grouped_plain", "candidate_plans",
           "validate_plan"]


def _launcher(route: str):
    lib = _build.load("opope_grouped")
    p, i, ep = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Epilogue)
    if route == "sm90":
        fn = lib.opope_grouped_sm90_launch
        argtypes = [p, p, p, i, i, i, i, p, i, i, i, ep, i, i, p]
    else:
        fn = lib.opope_grouped_launch
        argtypes = [p, p, p, i, i, i, i, i, i, i, p, i, i, i, i, i, ep, p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


# The sm90 route's ring at m <= 64 (csrc/opope_grouped.cu, config 0): 4
# stages a block, two blocks an SM, where K1's single block keeps 8.
_SM90_DECODE_STAGES = 4


def _plan(m: int, n: int, k: int, dtype: torch.dtype, a_ptr: int, b_ptr: int) -> Plan:
    """The route and tile of every group's ``A[g][m,k] @ B[g][k,n]``.

    A pure function of its arguments, cached on the shape, the dtype
    (:func:`.opope_gemm.plan_dtype`'s: None for a mixed pair) and the bases'
    16-byte alignment. The sm90 route takes bf16 or fp16 A and B of one
    dtype whose bases and row strides (``2k`` and ``2n`` bytes) are
    multiples of 16 bytes, with ``k > 0``: then the group strides (``2mk``
    and ``2kn``) are too, and rank-3 tensor maps describe both operands
    whatever G is. Anything else (fp32, the 8-bit floats and mixed pairs
    first of all) takes the tile route. The tile is K1's
    (64 rows at ``m <= 64``, 128 above); K is never split, since G times the
    N tiles fill the card on every MoE path.
    """
    return _plan_aligned(m, n, k, dtype, a_ptr % 16 == 0 and b_ptr % 16 == 0)


@functools.lru_cache(maxsize=1024)
def _plan_aligned(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool) -> Plan:
    return _grouped_stages(_unsplit_plan(m, n, k, dtype, aligned))


def _grouped_stages(plan: Plan) -> Plan:
    if plan.route == "sm90" and plan.config == 0:
        return plan._replace(stages=_SM90_DECODE_STAGES)
    return plan


def validate_plan(m: int, n: int, k: int, block: Tuple[int, int, int], splits: int = 1, *,
                  dtype: torch.dtype = torch.bfloat16, aligned: bool = True) -> Plan:
    """The plan of every group's ``A[g][m,k] @ B[g][k,n]`` on tile
    ``block``, or ValueError naming the hard constraint it breaks: K1's
    (:func:`repro_torch.kernels.opope_gemm.validate_plan`), and K never
    split."""
    return _validated(m, n, k, tuple(block), splits, dtype, aligned)


@functools.lru_cache(maxsize=1024)
def _validated(m: int, n: int, k: int, block: Tuple[int, int, int], splits: int,
               dtype: torch.dtype, aligned: bool) -> Plan:
    if splits != 1:
        raise ValueError(f"the grouped kernel never splits K (splits {splits})")
    return _grouped_stages(_k1_validated(m, n, k, block, 1, dtype, aligned))


def candidate_plans(m: int, n: int, k: int, *, dtype: torch.dtype = torch.bfloat16,
                    aligned: bool = True) -> List[Plan]:
    """Every legal sm90 plan of the groups' ``A[g][m,k] @ B[g][k,n]``: each
    compiled sm90 tile, K unsplit. Empty where the sm90 route does not take
    the operands."""
    if not _tma_ok(n, k, dtype, aligned):
        return []
    return [validate_plan(m, n, k, block, dtype=dtype, aligned=aligned) for block in _SM90_BLOCKS]


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
    """Plain PyTorch ``epilogue(A[g] @ B[g] (+ C[g]))``: both operands
    widened exactly, ``torch.bmm`` in fp32 (TF32 off), C added in fp32, the
    epilogue chain in fp32, one cast by K1's rule."""
    out_dtype = out_dtype or a.dtype
    _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    with full_fp32():
        acc = torch.bmm(a.float(), b.float())
    if c is not None:
        acc = acc + (c.float()[:, None, :] if c.ndim == 2 else c.float())
    acc = _ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
    return _ep.cast_out(acc, out_dtype)


def opope_gemm_grouped(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
    plan: Optional[Plan] = None,
) -> torch.Tensor:
    """``O[g] = epilogue(A[g] @ B[g] (+ C[g]))`` on the hand-written CUDA
    kernel, every group in one launch.

    a: [G, M, K], b: [G, K, N], each fp32, bf16, fp16, e4m3 or e5m2 (K1's
    dtype rule), contiguous. c: [G, M, N] or [G, N]. ``epilogue_operands``
    carries one canonical operand per operand-taking step (scalar
    ``(1,1,1)``, row ``(G,1,N)``, full ``(G,M,N)``). ``out_dtype`` is any of
    the five, or int8 behind ``requant_int8``; it defaults to ``a.dtype``. The route is :func:`_plan`'s,
    or ``plan``'s tile (:func:`validate_plan` on these operands; ValueError
    where the kernel cannot take it, on the CPU too).
    """
    if a.device.type == "cpu":
        if plan is not None:
            _forced(plan, a.shape[1], b.shape[2], a.shape[2], a, b)
        return opope_gemm_grouped_plain(
            a, b, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    return _run(a, b, c, out_dtype, epilogue, epilogue_operands, plan=plan)


def _forced(plan: Plan, m: int, n: int, k: int, a: torch.Tensor, b: torch.Tensor) -> Plan:
    """``plan``'s tile re-planned for each group's ``A[m,k] @ B[k,n]`` on
    these operands: one memo lookup, as :func:`_plan`; ValueError where
    illegal."""
    return _validated(m, n, k, (plan.bm, plan.bn, plan.bk), plan.splits,
                      plan_dtype(a.dtype, b.dtype),
                      a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _run(a, b, c, out_dtype, epilogue, epilogue_operands, route: Optional[str] = None,
         plan: Optional[Plan] = None):
    """One launch on the planned route, or on ``plan``'s tile; ``route``
    forces one (``"tile"`` takes every operand the kernels take; ``"sm90"``
    raises where the plan is not sm90), so a caller can time the two routes
    on the same call."""
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
    if plan is None:
        plan = _plan(m, n, k, plan_dtype(a.dtype, b.dtype), a.data_ptr(), b.data_ptr())
    else:
        plan = _forced(plan, m, n, k, a, b)
    if route == "sm90" and plan.route != "sm90":
        raise ValueError(f"the sm90 route does not take this call ({plan})")
    route = route or plan.route
    c_ptr = None if c is None else c.data_ptr()
    c_kind = 0 if c is None else (2 if c.ndim == 2 else 3)
    c_dtype = 0 if c is None else _DTYPE_CODES[c.dtype]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == "sm90":
            rc = _launcher("sm90")(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, n, k, c_ptr, c_kind, c_dtype,
                _DTYPE_CODES[out_dtype], ctypes.byref(ep), plan.config,
                int(a.dtype == torch.float16), stream,
            )
        else:
            compute = compute_dtype(a.dtype, b.dtype)
            vec_a, vec_b = _tile_vectors(compute, k, n, a, b)
            rc = _launcher("tile")(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, n, k,
                _DTYPE_CODES[a.dtype], _DTYPE_CODES[b.dtype], _DTYPE_CODES[compute],
                c_ptr, c_kind, c_dtype, _DTYPE_CODES[out_dtype], int(vec_a), int(vec_b),
                ctypes.byref(ep), stream,
            )
    if rc != 0:
        raise RuntimeError(f"opope_gemm_grouped {route} kernel launch failed: error {rc}")
    opope_gemm_grouped.launches += 1
    opope_gemm_grouped.launches_by_route[route] += 1
    return out


opope_gemm_grouped.launches = 0
opope_gemm_grouped.launches_by_route = {"sm90": 0, "tile": 0}
