"""int8 O-POPE GEMMs (K2, K5): the hand-written CUDA kernels and their plain
versions.

Ports :func:`repro.quant.pallas_q8.opope_gemm_q8` and
:func:`repro.quant.pallas_q8.opope_gemm_q8_grouped` (the Pallas TPU kernels).
All four functions here compute

    O = epilogue((A_q @ B_q) * (a_scale * b_scale) (+ C)), one cast

on int8 operands with fp32 scales: the int8 product is summed exactly in
int32, then dequantized with the scale product formed first, C added in
fp32, the epilogue chain run in fp32, and one cast to ``out_dtype`` (fp32 by
default; bf16, fp16, or int8 behind ``requant_int8``).

* :func:`opope_gemm_q8` launches ``kernels/csrc/opope_q8.cu`` (K2) and
  :func:`opope_gemm_q8_grouped` ``kernels/csrc/opope_q8_grouped.cu`` (K5)
  for tensors on the card (design notes there, in ``opope_q8_sm90.cuh`` and
  in ``opope_q8_tile.cuh``) and raise on what the kernels do not take.
  Given tensors on the CPU they run the plain versions: the kernels have no
  CPU form. ``.launches`` counts kernel launches and ``.launches_by_route``
  splits them by route.
* :func:`_plan` (K2) and :func:`_plan_grouped` (K5) choose the route before
  the launch, from the operands alone: ``"sm90"`` (TMA ring + int8 wgmma
  with the weight as the register operand; K2 splits K exactly in int32
  where the output tiles do not fill the card, K5 runs every group in one
  grid over rank-3 tensor maps and never splits K) where a TMA tensor map
  can describe both operands, else ``"tile"`` (the 64x64 mma.sync tile
  body).
* :func:`opope_gemm_q8_plain` / :func:`opope_gemm_q8_grouped_plain` form the
  exact integer product (an int32 matmul on the CPU; on the card an fp64
  one, exact while |acc| < 2^53, never fp32 or TF32), then the same
  writeback: the CPU path and the reference the kernels are held against.

The int32 accumulator is exact while K * 127^2 < 2^31, i.e. K <= ``MAX_K``;
longer products raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import epilogue as _ep
from repro_torch.kernels.opope_gemm import (
    _DTYPE_CODES,
    _OPERAND_DTYPES,
    _SM_COUNT,
    _TILE,
    MAX_EPILOGUE_STEPS,
    Plan,
    _counters,
    _Epilogue,
    _epilogue_struct,
    _split_bounds,
)

__all__ = [
    "MAX_K",
    "opope_gemm_q8",
    "opope_gemm_q8_plain",
    "opope_gemm_q8_grouped",
    "opope_gemm_q8_grouped_plain",
]

MAX_K = (2**31 - 1) // (127 * 127)


def _launcher(name: str, grouped: bool):
    fn = getattr(_build.load("opope_q8_grouped" if grouped else "opope_q8"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 5 + [i] * (4 if grouped else 3) + [p] + [i] * 5
                       + [ctypes.POINTER(_Epilogue), p])
        fn.restype = ctypes.c_int
    return fn


def _sm90_launcher():
    fn = _build.load("opope_q8").opope_q8_gemm_sm90_launch
    if fn.argtypes is None:
        p, i, ep = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Epilogue)
        fn.argtypes = [p] * 5 + [i] * 3 + [p] + [i] * 3 + [ep, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _grouped_sm90_launcher():
    fn = _build.load("opope_q8_grouped").opope_q8_grouped_sm90_launch
    if fn.argtypes is None:
        p, i, ep = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Epilogue)
        fn.argtypes = [p] * 5 + [i] * 4 + [p] + [i] * 3 + [ep, i, p]
        fn.restype = ctypes.c_int
    return fn


# The sm90 body (csrc/opope_q8_sm90.cuh): K bytes a ring stage, weight
# columns a block, and K2's two tile configurations: config code, MT (rows
# of A_q a block, wgmma's N), stages.
_SM90_BK = 128
_SM90_BN = 128
_SM90_CONFIGS = ((0, 8, 8), (1, 128, 4))
# K5's (csrc/opope_q8_grouped.cu): the same two tiles, each as two blocks
# an SM, and so with fewer stages: MT -> stages. Phase 7 of chip_smoke.py
# timed them faster than K2's one block an SM on deepseek-moe-16b's experts
# at capacities 1, 30 and 60.
_GROUPED_STAGES = {8: 4, 128: 3}
_MAX_GROUPS = 65535  # the launch grid's z dimension, one group an index
_MIN_SPLIT_PANELS = 2  # each split walks at least this many BK panels when it can


def _max_splits(m: int, k: int, mt: int) -> int:
    """The most K splits worth taking on the sm90 route: each split walks
    at least ``_MIN_SPLIT_PANELS`` panels, and the last block of a tile,
    which reads every split's int32 partial (``rows x 128``) alone, reads no
    more than one split streams through its main loop (``k / S`` deep
    panels of A_q's ``rows`` and the weight's 128 int8 columns):
    ``S * rows * 128 * 4 <= (k / S) * (rows + 128)``."""
    rows = min(m, mt)
    by_panels = -(-k // _SM90_BK) // _MIN_SPLIT_PANELS
    by_reduction = math.isqrt(k * (rows + _SM90_BN) // (4 * rows * _SM90_BN))
    return max(1, min(by_panels, by_reduction))


def _plan(m: int, n: int, k: int, a_ptr: int, b_ptr: int) -> Plan:
    """The route, tile, stage count and K splits of K2's ``A_q[m,k] @
    B_q[k,n]`` (int8, contiguous).

    A pure function of its arguments. The sm90 route takes operands whose
    bases and row strides (``k`` and ``n`` bytes) are multiples of 16 bytes,
    as a TMA tensor map needs, with ``k > 0``; anything else takes the tile
    route. On the sm90 route the tile is 8 rows of A_q for ``m <= 8``, else
    128 (rows past ``m`` zero-filled), by 128 weight columns, and K is
    split across blocks when the output tiles alone do not fill the card:
    the most splits that keep the grid within one wave of ``_SM_COUNT``
    blocks, up to :func:`_max_splits`, none empty.
    """
    return _plan_aligned(m, n, k, a_ptr % 16 == 0 and b_ptr % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _plan_aligned(m: int, n: int, k: int, aligned: bool) -> Plan:
    # Only the bases' alignment enters the plan: cached on it (a decode
    # step plans the same few shapes hundreds of times).
    if not (aligned and k > 0 and k % 16 == 0 and n % 16 == 0):
        bm, bn, bk = _TILE
        return Plan("tile", -1, bm, bn, bk, 2, 1, -(-m // bm), -(-n // bn), (0, k))
    config, mt, stages = next((c for c in _SM90_CONFIGS if m <= c[1]), _SM90_CONFIGS[-1])
    m_tiles, n_tiles = -(-m // mt), -(-n // _SM90_BN)
    splits = max(1, min(_SM_COUNT // (m_tiles * n_tiles), _max_splits(m, k, mt)))
    return Plan("sm90", config, mt, _SM90_BN, _SM90_BK, stages, splits, m_tiles, n_tiles,
                _split_bounds(k, _SM90_BK, splits))


def _plan_grouped(g: int, m: int, n: int, k: int, a_ptr: int, b_ptr: int) -> Plan:
    """The route and tile of K5's ``A_q[g][m,k] @ B_q[g][k,n]`` for every
    group (int8, contiguous).

    A pure function of its arguments, cached on the shape and the bases'
    16-byte alignment; raises for more groups than the launch grid holds
    (``g > 65535``). The sm90 route takes what K2's takes (bases aligned,
    ``k`` and ``n`` multiples of 16, ``k > 0``): then every row and group
    stride is a multiple of 16 bytes too, and rank-3 tensor maps describe
    both operands. Its tile is K2's, 8 rows of A_q at ``m <= 8``, else 128,
    by 128 weight columns, with ``_GROUPED_STAGES`` stages; K is never split (G times the N tiles fill the card on every
    MoE path). Anything else takes the tile route.
    """
    if g > _MAX_GROUPS:
        raise ValueError(f"{g} groups > {_MAX_GROUPS}: the launch grid holds one group an index")
    return _plan_grouped_aligned(m, n, k, a_ptr % 16 == 0 and b_ptr % 16 == 0)


@functools.lru_cache(maxsize=1024)
def _plan_grouped_aligned(m: int, n: int, k: int, aligned: bool) -> Plan:
    plan = _plan_aligned(m, n, k, aligned)
    if plan.route != "sm90":
        return plan
    return plan._replace(stages=_GROUPED_STAGES[plan.bm], splits=1, k_bounds=(0, k))


def _check_common(k, c, c_shapes, out_dtype, epilogue, epilogue_operands):
    if k > MAX_K:
        raise ValueError(f"K = {k} > {MAX_K}: the int32 accumulator of int8 products "
                         "could overflow")
    if c is not None and tuple(c.shape) not in c_shapes:
        raise ValueError(f"C preload shape {tuple(c.shape)} != one of {c_shapes}")
    if out_dtype == torch.int8 and (not epilogue or epilogue[-1] != "requant_int8"):
        raise ValueError("int8 output needs an epilogue chain ending in requant_int8")
    n_ops = sum(1 for s in epilogue if _ep.op_kind(s) != "none")
    if n_ops != len(epilogue_operands):
        raise ValueError(
            f"epilogue {epilogue} takes {n_ops} operands, got {len(epilogue_operands)}"
        )


def _check_shapes(a_q, a_scale, b_q, b_scale, c, out_dtype, epilogue, epilogue_operands):
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a_q.shape)} @ {tuple(b_q.shape)}")
    (m, k), n = a_q.shape, b_q.shape[1]
    if tuple(a_scale.shape) != (m, 1):
        raise ValueError(f"a_scale shape {tuple(a_scale.shape)} != {(m, 1)}")
    if tuple(b_scale.shape) != (1, n):
        raise ValueError(f"b_scale shape {tuple(b_scale.shape)} != {(1, n)}")
    _check_common(k, c, ((n,), (m, n)), out_dtype, epilogue, epilogue_operands)
    return m, n, k


def _check_grouped_shapes(a_q, a_scale, b_q, b_scale, c, out_dtype, epilogue,
                          epilogue_operands):
    if (a_q.ndim != 3 or b_q.ndim != 3 or a_q.shape[0] != b_q.shape[0]
            or a_q.shape[2] != b_q.shape[1]):
        raise ValueError(f"bad grouped GEMM shapes {tuple(a_q.shape)} @ {tuple(b_q.shape)}")
    (g, m, k), n = a_q.shape, b_q.shape[2]
    if tuple(a_scale.shape) != (g, m, 1):
        raise ValueError(f"a_scale shape {tuple(a_scale.shape)} != {(g, m, 1)}")
    if tuple(b_scale.shape) != (g, 1, n):
        raise ValueError(f"b_scale shape {tuple(b_scale.shape)} != {(g, 1, n)}")
    _check_common(k, c, ((g, n), (g, m, n)), out_dtype, epilogue, epilogue_operands)
    return g, m, n, k


def _check_launch_operands(fn, a_q, a_scale, b_q, b_scale, c, out_dtype, epilogue,
                           epilogue_operands):
    """What a kernel launch takes: int8 values, fp32 scales, a known out
    dtype, at most 8 epilogue steps, contiguous operands on one device."""
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"{fn} takes int8 values, got {a_q.dtype} @ {b_q.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError(f"{fn} takes fp32 scales, got {a_scale.dtype}, {b_scale.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if len(epilogue) > MAX_EPILOGUE_STEPS:
        raise ValueError(f"at most {MAX_EPILOGUE_STEPS} epilogue steps, got {len(epilogue)}")
    rest = ([c] if c is not None else []) + list(epilogue_operands)
    for t in [a_q, a_scale, b_q, b_scale] + rest:
        if t.device != a_q.device:
            raise ValueError(f"operand on {t.device}, GEMM on {a_q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} takes contiguous operands")
    for t in rest:
        if t.dtype not in _OPERAND_DTYPES:
            raise TypeError(f"unsupported C/epilogue operand dtype {t.dtype}")


def _exact_product(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """The exact integer product of int8 operands (2-D or batched 3-D)."""
    if a_q.device.type == "cpu":
        return torch.matmul(a_q.to(torch.int32), b_q.to(torch.int32))
    # No integer matmul on the card outside _int_mm; fp64 is exact here.
    return torch.matmul(a_q.double(), b_q.double())


def _writeback(acc, a_scale, b_scale, c, out_dtype, epilogue, epilogue_operands):
    out = acc.float() * (a_scale.float() * b_scale.float())
    if c is not None:
        cf = c.float()
        out = out + (cf[:, None, :] if acc.ndim == 3 and c.ndim == 2 else cf)
    out = _ep.apply_epilogue(out, tuple(epilogue), tuple(epilogue_operands))
    return out.to(out_dtype)


def opope_gemm_q8_plain(
    a_q: torch.Tensor,
    a_scale: torch.Tensor,
    b_q: torch.Tensor,
    b_scale: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """Plain PyTorch ``epilogue((A_q @ B_q) * (a_scale * b_scale) (+ C))``:
    the exact integer product, the same writeback as the kernel."""
    out_dtype = out_dtype or torch.float32
    _check_shapes(a_q, a_scale, b_q, b_scale, c, out_dtype, epilogue, epilogue_operands)
    return _writeback(_exact_product(a_q, b_q), a_scale, b_scale, c, out_dtype,
                      epilogue, epilogue_operands)


def opope_gemm_q8_grouped_plain(
    a_q: torch.Tensor,
    a_scale: torch.Tensor,
    b_q: torch.Tensor,
    b_scale: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """Plain PyTorch grouped ``epilogue((A_q[g] @ B_q[g]) * (a_scale[g] *
    b_scale[g]) (+ C[g]))``: the exact batched integer product, the same
    writeback as the kernel."""
    out_dtype = out_dtype or torch.float32
    _check_grouped_shapes(a_q, a_scale, b_q, b_scale, c, out_dtype, epilogue,
                          epilogue_operands)
    return _writeback(_exact_product(a_q, b_q), a_scale, b_scale, c, out_dtype,
                      epilogue, epilogue_operands)


def _launch_tile(fn_name, grouped, a_q, a_scale, b_q, b_scale, c, out, dims, out_dtype, ep):
    """One launch of the tile body (the tile route of K2, or of K5)."""
    k = a_q.shape[-1]
    n = b_q.shape[-1]
    # 16-byte A vectors stay inside a row (and every group's base aligned)
    # when K is a multiple of 16; 4-byte B words likewise when N is of 4.
    vec_a = k % 16 == 0 and a_q.data_ptr() % 16 == 0
    vec_b = n % 4 == 0 and b_q.data_ptr() % 4 == 0
    c_kind = 0 if c is None else (3 if c.ndim == a_q.ndim else 2)
    launch = _launcher(fn_name, grouped)
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream(a_q.device).cuda_stream
        rc = launch(
            a_q.data_ptr(), a_scale.data_ptr(), b_q.data_ptr(), b_scale.data_ptr(),
            out.data_ptr(), *dims, None if c is None else c.data_ptr(), c_kind,
            0 if c is None else _DTYPE_CODES[c.dtype], _DTYPE_CODES[out_dtype],
            int(vec_a), int(vec_b), ctypes.byref(ep), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")


def _launch(
    a_q: torch.Tensor,
    a_scale: torch.Tensor,
    b_q: torch.Tensor,
    b_scale: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
    route: Optional[str] = None,
) -> torch.Tensor:
    """One K2 launch on the planned route; ``route`` forces one (``"tile"``
    takes every operand the kernel takes; ``"sm90"`` raises, launching
    nothing, where the plan is not sm90), so a caller can hold and time the
    two routes on the same call."""
    if a_q.device.type != "cuda":
        raise ValueError(f"opope_gemm_q8 runs on cuda tensors, got {a_q.device}")
    out_dtype = out_dtype or torch.float32
    m, n, k = _check_shapes(a_q, a_scale, b_q, b_scale, c, out_dtype, epilogue,
                            epilogue_operands)
    _check_launch_operands("opope_gemm_q8", a_q, a_scale, b_q, b_scale, c, out_dtype,
                           epilogue, epilogue_operands)
    ep = _epilogue_struct(epilogue, epilogue_operands,
                          {"scalar": (1, 1), "row": (1, n), "full": (m, n)})
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if m == 0 or n == 0:
        return out
    plan = _plan(m, n, k, a_q.data_ptr(), b_q.data_ptr())
    if route == "sm90" and plan.route != "sm90":
        raise ValueError(f"the sm90 route does not take this call ({plan})")
    route = route or plan.route
    if route == "sm90":
        with torch.cuda.device(a_q.device):
            stream = torch.cuda.current_stream(a_q.device).cuda_stream
            ws = counters = None
            if plan.splits > 1:
                ws = torch.empty(plan.splits * plan.tiles * plan.bm * plan.bn,
                                 dtype=torch.int32, device=a_q.device)
                counters = _counters(a_q.device, stream)
            rc = _sm90_launcher()(
                a_q.data_ptr(), a_scale.data_ptr(), b_q.data_ptr(), b_scale.data_ptr(),
                out.data_ptr(), m, n, k, None if c is None else c.data_ptr(),
                0 if c is None else (2 if c.ndim == 1 else 3),
                0 if c is None else _DTYPE_CODES[c.dtype], _DTYPE_CODES[out_dtype],
                ctypes.byref(ep), plan.config, plan.splits,
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"opope_gemm_q8 sm90 kernel launch failed: error {rc}")
    else:
        _launch_tile("opope_q8_gemm_launch", False, a_q, a_scale, b_q, b_scale, c, out,
                     (m, n, k), out_dtype, ep)
    opope_gemm_q8.launches += 1
    opope_gemm_q8.launches_by_route[route] += 1
    return out


def opope_gemm_q8(
    a_q: torch.Tensor,
    a_scale: torch.Tensor,
    b_q: torch.Tensor,
    b_scale: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """``O = epilogue((A_q @ B_q) * (a_scale * b_scale) (+ C))`` on the
    hand-written CUDA kernel K2.

    a_q: [M, K] int8 with row scales a_scale [M, 1] fp32; b_q: [K, N] int8
    with column scales b_scale [1, N] fp32; c: [M, N] or [N]; all
    contiguous. ``epilogue_operands`` carries one canonical operand per
    operand-taking step (scalar ``(1,1)``, row ``(1,N)``, full ``(M,N)``).
    ``out_dtype`` defaults to fp32. The route is :func:`_plan`'s.
    """
    if a_q.device.type == "cpu":
        return opope_gemm_q8_plain(
            a_q, a_scale, b_q, b_scale, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    return _launch(a_q, a_scale, b_q, b_scale, c, out_dtype=out_dtype, epilogue=epilogue,
                   epilogue_operands=epilogue_operands)


def opope_gemm_q8_grouped(
    a_q: torch.Tensor,
    a_scale: torch.Tensor,
    b_q: torch.Tensor,
    b_scale: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """Grouped ``O[g] = epilogue((A_q[g] @ B_q[g]) * (a_scale[g] *
    b_scale[g]) (+ C[g]))`` on the hand-written CUDA kernel K5, every group
    in one launch.

    a_q: [G, M, K] int8 with scales [G, M, 1]; b_q: [G, K, N] int8 with
    scales [G, 1, N]; c: [G, M, N] or [G, N]; all contiguous.
    ``epilogue_operands``: scalar ``(1,1,1)``, row ``(G,1,N)``, full
    ``(G,M,N)``. ``out_dtype`` defaults to fp32. The route is
    :func:`_plan_grouped`'s.
    """
    if a_q.device.type == "cpu":
        return opope_gemm_q8_grouped_plain(
            a_q, a_scale, b_q, b_scale, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    return _launch_grouped(a_q, a_scale, b_q, b_scale, c, out_dtype=out_dtype,
                           epilogue=epilogue, epilogue_operands=epilogue_operands)


def _launch_grouped(
    a_q: torch.Tensor,
    a_scale: torch.Tensor,
    b_q: torch.Tensor,
    b_scale: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
    route: Optional[str] = None,
) -> torch.Tensor:
    """One K5 launch on the planned route; ``route`` forces one (``"tile"``
    takes every operand the kernel takes; ``"sm90"`` raises, launching
    nothing, where the plan is not sm90), so a caller can hold and time both
    on the same call."""
    if a_q.device.type != "cuda":
        raise ValueError(f"opope_gemm_q8_grouped runs on cuda tensors, got {a_q.device}")
    out_dtype = out_dtype or torch.float32
    g, m, n, k = _check_grouped_shapes(a_q, a_scale, b_q, b_scale, c, out_dtype,
                                       epilogue, epilogue_operands)
    _check_launch_operands("opope_gemm_q8_grouped", a_q, a_scale, b_q, b_scale, c,
                           out_dtype, epilogue, epilogue_operands)
    ep = _epilogue_struct(epilogue, epilogue_operands,
                          {"scalar": (1, 1, 1), "row": (g, 1, n), "full": (g, m, n)})
    plan = _plan_grouped(g, m, n, k, a_q.data_ptr(), b_q.data_ptr())
    if route == "sm90" and plan.route != "sm90":
        raise ValueError(f"the sm90 route does not take this call ({plan})")
    route = route or plan.route
    out = torch.empty((g, m, n), dtype=out_dtype, device=a_q.device)
    if g == 0 or m == 0 or n == 0:
        return out
    if route == "sm90":
        with torch.cuda.device(a_q.device):
            stream = torch.cuda.current_stream(a_q.device).cuda_stream
            rc = _grouped_sm90_launcher()(
                a_q.data_ptr(), a_scale.data_ptr(), b_q.data_ptr(), b_scale.data_ptr(),
                out.data_ptr(), g, m, n, k, None if c is None else c.data_ptr(),
                0 if c is None else (2 if c.ndim == 2 else 3),
                0 if c is None else _DTYPE_CODES[c.dtype], _DTYPE_CODES[out_dtype],
                ctypes.byref(ep), plan.config, stream,
            )
        if rc != 0:
            raise RuntimeError(f"opope_gemm_q8_grouped sm90 kernel launch failed: error {rc}")
    else:
        _launch_tile("opope_q8_grouped_launch", True, a_q, a_scale, b_q, b_scale, c, out,
                     (g, m, n, k), out_dtype, ep)
    opope_gemm_q8_grouped.launches += 1
    opope_gemm_q8_grouped.launches_by_route[route] += 1
    return out


opope_gemm_q8.launches = 0
opope_gemm_q8.launches_by_route = {"sm90": 0, "tile": 0}
opope_gemm_q8_grouped.launches = 0
opope_gemm_q8_grouped.launches_by_route = {"sm90": 0, "tile": 0}
