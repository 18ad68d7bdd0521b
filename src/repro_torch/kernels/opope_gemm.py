"""O-POPE GEMM: the hand-written CUDA kernel and its plain PyTorch version.

Ports :func:`repro.kernels.opope_gemm.opope_gemm` (the Pallas TPU kernel).
Both functions here compute ``O = epilogue(A[M,K] @ B[K,N] (+ C))`` with an
fp32 accumulator, ``C`` a full ``[M, N]`` tile or an ``[N]`` bias row
preloaded into it, the epilogue chain run on the fp32 accumulator, and one
cast to ``out_dtype`` at the end.

* :func:`opope_gemm` launches ``csrc/opope_gemm.cu`` for tensors on the card
  (design notes are in that file) and raises on what the kernel does not
  take. Given tensors on the CPU it runs :func:`opope_gemm_plain`: the kernel
  has no CPU form. ``opope_gemm.launches`` counts kernel launches, and
  ``opope_gemm.launches_by_route`` splits them by route.
* :func:`_plan` chooses the route before the launch, from the operands
  alone: ``"sm90"`` (TMA + wgmma, split-K where the output tiles do not
  fill the card) for bf16 operands whose row strides and bases TMA can
  describe, else ``"tile"`` (the 64x64 tile body shared with the grouped
  kernel; fp32 inputs always go there).
* :func:`opope_gemm_plain` is ``a.float() @ b.float()`` (TF32 off) plus C,
  the same epilogue chain, one cast: the CPU path and the reference the
  kernel is held against on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from . import build as _build
from . import epilogue as _ep

__all__ = ["opope_gemm", "opope_gemm_plain", "full_fp32", "MAX_EPILOGUE_STEPS"]

MAX_EPILOGUE_STEPS = 8

# dtype codes shared with csrc/opope_tile.cuh
_DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int8: 3,
}
_IN_DTYPES = (torch.float32, torch.bfloat16)
_OPERAND_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class _Epilogue(ctypes.Structure):
    """Mirror of ``struct OpopeEpilogue`` in csrc/opope_tile.cuh."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("op", ctypes.c_int * MAX_EPILOGUE_STEPS),
        ("kind", ctypes.c_int * MAX_EPILOGUE_STEPS),
        ("dtype", ctypes.c_int * MAX_EPILOGUE_STEPS),
        ("ptr", ctypes.c_void_p * MAX_EPILOGUE_STEPS),
    ]


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """fp32 products on the card in full fp32, never TF32, inside the block
    (the plain versions and the model's fp32 einsums run in it)."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def _launcher(route: str):
    lib = _build.load("opope_gemm")
    p, i, ep = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Epilogue)
    if route == "sm90":
        fn = lib.opope_gemm_sm90_launch
        argtypes = [p, p, p, i, i, i, p, i, i, i, ep, i, i, p, p, p]
    else:
        fn = lib.opope_gemm_launch
        argtypes = [p, p, p, i, i, i, i, p, i, i, i, i, i, ep, p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


# The sm90 route's two tile configurations (csrc/opope_gemm.cu): config code,
# BM, BN, stages. Decode (M <= 64) takes one consumer warpgroup on 64 rows,
# prefill two on 128.
_SM90_BK = 64
_SM90_DECODE = (0, 64, 128, 8)
_SM90_PREFILL = (1, 128, 128, 5)
_SM_COUNT = 132  # H100 SXM: one wave of the one-block-an-SM sm90 configs
_MIN_SPLIT_PANELS = 4  # each split walks at least this many BK panels when it can
_TILE = (64, 64, 32)  # the tile route's BM, BN, BK (csrc/opope_tile.cuh)


class Plan(NamedTuple):
    """How one K1 call runs. ``k_bounds`` are the splits' K offsets, first 0
    and last K; split ``s`` covers ``[k_bounds[s], k_bounds[s+1])``."""

    route: str  # "sm90" or "tile"
    config: int  # sm90 config code (0 decode, 1 prefill); -1 on the tile route
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    m_tiles: int
    n_tiles: int
    k_bounds: Tuple[int, ...]

    @property
    def tiles(self) -> int:
        """Output tiles (blocks per split)."""
        return self.m_tiles * self.n_tiles


def _split_bounds(k: int, bk: int, splits: int) -> Tuple[int, ...]:
    """K offsets of ``splits`` splits over ``ceil(k / bk)`` panels: a whole
    number of panels each, the first ``panels % splits`` one more (the
    kernel computes the same from its split index)."""
    panels = -(-k // bk)
    per, rem = divmod(panels, splits)
    return tuple(min(k, bk * (s * per + min(s, rem))) for s in range(splits + 1))


def _max_splits(m: int, k: int, bm: int, bn: int) -> int:
    """The most K splits worth taking on the sm90 route: each split walks
    at least ``_MIN_SPLIT_PANELS`` panels, and the last block of a tile,
    which reads every split's fp32 partial (``rows x bn``) alone, reads no
    more than one split streams through its main loop (``k / splits`` deep
    panels of A's ``rows`` and B's ``bn`` bf16 columns):
    ``S * rows * bn * 4 <= (k / S) * (rows + bn) * 2``. At decode (4 rows)
    the panel rule binds (16 splits of K = 4096); at a 128-row prefill
    tile the reduction rule does (5)."""
    rows = min(m, bm)
    by_panels = -(-k // _SM90_BK) // _MIN_SPLIT_PANELS
    by_reduction = math.isqrt(k * (rows + bn) // (2 * rows * bn))
    return max(1, min(by_panels, by_reduction))


def _plan(m: int, n: int, k: int, dtype: torch.dtype, a_ptr: int, b_ptr: int) -> Plan:
    """The route, tile, stage count and K splits of ``A[m,k] @ B[k,n]``.

    A pure function of its arguments. The sm90 route takes bf16 A and B
    whose bases and row strides (``2k`` and ``2n`` bytes) are multiples of
    16 bytes, as a TMA tensor map needs, with ``k > 0``; anything else (fp32
    inputs first of all) takes the tile route. On the sm90 route K is split
    across blocks when the output tiles alone do not fill the card: the
    most splits that keep the grid within one wave of ``_SM_COUNT`` blocks,
    up to :func:`_max_splits`, none empty.
    """
    return _plan_aligned(m, n, k, dtype, a_ptr % 16 == 0 and b_ptr % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _plan_aligned(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool) -> Plan:
    # Only the bases' alignment enters the plan: cached on it (a decode
    # step plans the same few shapes hundreds of times).
    plan = _unsplit_plan(m, n, k, dtype, aligned)
    if plan.route != "sm90":
        return plan
    splits = max(1, min(_SM_COUNT // plan.tiles, _max_splits(m, k, plan.bm, plan.bn)))
    return plan._replace(splits=splits, k_bounds=_split_bounds(k, _SM90_BK, splits))


@functools.lru_cache(maxsize=4096)
def _unsplit_plan(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The route and tile of ``A[m,k] @ B[k,n]`` with K in one split: the
    sm90 route for bf16 operands a TMA tensor map describes (row strides
    ``2k`` and ``2n`` bytes and bases multiples of 16, ``k > 0``), the
    64-row tile at ``m <= 64``, the 128-row one above; else the tile route.
    The grouped kernel (K4) takes this plan for each of its groups."""
    tma_ok = (dtype == torch.bfloat16 and k > 0 and (2 * k) % 16 == 0 and (2 * n) % 16 == 0
              and aligned)
    if not tma_ok:
        bm, bn, bk = _TILE
        return Plan("tile", -1, bm, bn, bk, 2, 1, -(-m // bm), -(-n // bn), (0, k))
    config, bm, bn, stages = _SM90_DECODE if m <= 64 else _SM90_PREFILL
    return Plan("sm90", config, bm, bn, _SM90_BK, stages, 1, -(-m // bm), -(-n // bn), (0, k))


# One zeroed split-K counter per output tile, kept per (device, stream):
# calls on one stream run in order and each leaves the counters it used at
# zero; calls on two streams get two buffers. A call splits only when two
# or more splits of its tiles fit one wave, so it has at most _SM_COUNT // 2.
_N_COUNTERS = _SM_COUNT // 2
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(_N_COUNTERS, dtype=torch.int32, device=device)
    return buf


def _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, n = a.shape[0], b.shape[1]
    if c is not None and tuple(c.shape) not in ((n,), (m, n)):
        raise ValueError(f"C preload shape {tuple(c.shape)} != {(n,)} or {(m, n)}")
    if out_dtype == torch.int8 and (not epilogue or epilogue[-1] != "requant_int8"):
        raise ValueError("int8 output needs an epilogue chain ending in requant_int8")
    n_ops = sum(1 for s in epilogue if _ep.op_kind(s) != "none")
    if n_ops != len(epilogue_operands):
        raise ValueError(
            f"epilogue {epilogue} takes {n_ops} operands, got {len(epilogue_operands)}"
        )
    return m, n


def _check_launch_operands(fn, a, b, c, out_dtype, epilogue, epilogue_operands):
    """What a kernel launch takes: bf16 or fp32 inputs of one dtype, a known
    out dtype, at most 8 epilogue steps, contiguous operands on one device."""
    if a.dtype not in _IN_DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"{fn} takes bf16 or fp32 inputs of one dtype, got {a.dtype} @ {b.dtype}"
        )
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if len(epilogue) > MAX_EPILOGUE_STEPS:
        raise ValueError(f"at most {MAX_EPILOGUE_STEPS} epilogue steps, got {len(epilogue)}")
    tensors = [a, b] + ([c] if c is not None else []) + list(epilogue_operands)
    for t in tensors:
        if t.device != a.device:
            raise ValueError(f"operand on {t.device}, GEMM on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} takes contiguous operands")
    for t in tensors[2:]:
        if t.dtype not in _OPERAND_DTYPES:
            raise TypeError(f"unsupported C/epilogue operand dtype {t.dtype}")


def _epilogue_struct(epilogue, epilogue_operands, shapes) -> _Epilogue:
    """The chain as the kernels' by-value struct; ``shapes`` maps each
    operand kind to the canonical shape its operand must have."""
    ep = _Epilogue()
    ep.n_steps = len(epilogue)
    it = iter(epilogue_operands)
    for s, name in enumerate(epilogue):
        op = _ep.op_def(name)
        ep.op[s] = op.code
        ep.kind[s] = _ep.KIND_CODES[op.kind]
        if op.kind != "none":
            x = next(it)
            want = shapes[op.kind]
            if tuple(x.shape) != want:
                raise ValueError(f"epilogue {name!r} operand {tuple(x.shape)} != {want}")
            ep.dtype[s] = _DTYPE_CODES[x.dtype]
            ep.ptr[s] = x.data_ptr()
    return ep


def opope_gemm_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """Plain PyTorch ``epilogue(A @ B (+ C))``: fp32 product (TF32 off),
    C added in fp32, the epilogue chain in fp32, one cast."""
    out_dtype = out_dtype or a.dtype
    _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    with full_fp32():
        acc = a.float() @ b.float()
    if c is not None:
        acc = acc + c.float()
    acc = _ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
    return acc.to(out_dtype)


def opope_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """``O = epilogue(A @ B (+ C))`` on the hand-written CUDA kernel.

    a: [M, K], b: [K, N], both bf16 or both fp32, contiguous. c: [M, N] or
    [N]. ``epilogue`` names up to 8 registered steps; ``epilogue_operands``
    carries one canonical operand per operand-taking step (scalar ``(1,1)``,
    row ``(1,N)``, full ``(M,N)``). ``out_dtype`` is bf16, fp16 or fp32, or
    int8 behind ``requant_int8``; it defaults to ``a.dtype``. The route is
    :func:`_plan`'s.
    """
    if a.device.type == "cpu":
        return opope_gemm_plain(
            a, b, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    return _run(a, b, c, out_dtype, epilogue, epilogue_operands)


def _run(a, b, c, out_dtype, epilogue, epilogue_operands, route: Optional[str] = None):
    """One launch on the planned route; ``route`` forces one (``"tile"``
    takes every operand the kernels take; ``"sm90"`` raises where the plan
    is not sm90), so a caller can time the two routes on the same call."""
    if a.device.type != "cuda":
        raise ValueError(f"opope_gemm runs on cuda tensors, got {a.device}")
    out_dtype = out_dtype or a.dtype
    m, n = _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    k = a.shape[1]
    _check_launch_operands("opope_gemm", a, b, c, out_dtype, epilogue, epilogue_operands)
    ep = _epilogue_struct(epilogue, epilogue_operands,
                          {"scalar": (1, 1), "row": (1, n), "full": (m, n)})

    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    plan = _plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr())
    if route == "sm90" and plan.route != "sm90":
        raise ValueError(f"the sm90 route does not take this call ({plan})")
    route = route or plan.route
    c_ptr = None if c is None else c.data_ptr()
    c_kind = 0 if c is None else (2 if c.ndim == 1 else 3)
    c_dtype = 0 if c is None else _DTYPE_CODES[c.dtype]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == "sm90":
            ws = counters = None
            if plan.splits > 1:
                ws = torch.empty(plan.splits * plan.tiles * plan.bm * plan.bn,
                                 dtype=torch.float32, device=a.device)
                counters = _counters(a.device, stream)
            rc = _launcher("sm90")(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, c_ptr, c_kind, c_dtype,
                _DTYPE_CODES[out_dtype], ctypes.byref(ep), plan.config, plan.splits,
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), stream,
            )
        else:
            vec = 16 // a.element_size()
            vec_a = k % vec == 0 and a.data_ptr() % 16 == 0
            vec_b = n % vec == 0 and b.data_ptr() % 16 == 0
            rc = _launcher("tile")(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                _DTYPE_CODES[a.dtype], c_ptr, c_kind, c_dtype,
                _DTYPE_CODES[out_dtype], int(vec_a), int(vec_b),
                ctypes.byref(ep), stream,
            )
    if rc != 0:
        raise RuntimeError(f"opope_gemm {route} kernel launch failed: error {rc}")
    opope_gemm.launches += 1
    opope_gemm.launches_by_route[route] += 1
    return out


opope_gemm.launches = 0
opope_gemm.launches_by_route = {"sm90": 0, "tile": 0}
