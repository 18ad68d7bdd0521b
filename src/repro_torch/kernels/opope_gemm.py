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
  fill the card) for bf16 or fp16 operands of one dtype whose row strides
  and bases TMA can describe, else ``"tile"`` (the 64x64 tile body shared
  with the grouped kernel; fp32, the 8-bit floats and mixed pairs always go
  there).
* :func:`opope_gemm_plain` is ``a.float() @ b.float()`` (TF32 off) plus C,
  the same epilogue chain, one cast: the CPU path and the reference the
  kernel is held against on the card.

The dtype rule, as the reference's kernel takes its inputs:

* A and B are each fp32, bf16, fp16, e4m3 (``float8_e4m3fn``) or e5m2
  (``float8_e5m2``), in any pair. ``out_dtype`` defaults to A's dtype.
* The compute type (:func:`compute_dtype`) is the narrowest of fp16, bf16
  and fp32 that holds both operands exactly: two 8-bit floats, or fp16 with
  an 8-bit float, compute in fp16 (both 8-bit formats are exact in fp16);
  bf16 with an 8-bit float or with bf16 in bf16; fp16 with bf16, or
  anything with fp32, in fp32. Every product of two compute-type values is
  exact in fp32, so the kernels differ from the reference only by the fp32
  order of summation. The kernel widens each operand on its way from
  device memory to shared memory; no widened copy is written to device
  memory.
* The final cast, in the plain versions (:func:`.epilogue.cast_out`) and
  the kernels' writeback alike, follows the reference's rule: round to
  nearest even; fp16, bf16 and e5m2 overflow to infinity; e4m3 past 448
  gives NaN (torch's own cast would saturate to 448).
* C and the epilogue operands may be any of the five too; each is read as
  fp32.

The plan is the kernel's tuning knob (:mod:`repro_torch.tune`): a compiled
tile configuration, named by its block ``(bm, bn, bk)``, and on the sm90
route a K split count. :func:`candidate_plans` lists every legal sm90 plan of
a shape, :func:`validate_plan` builds the plan of one knob or raises where
the kernel cannot take it, and :func:`opope_gemm` takes a ``plan=`` whose
knob it runs (re-planned for its operands; an illegal one raises, it never
falls back).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from . import build as _build
from . import epilogue as _ep

__all__ = ["opope_gemm", "opope_gemm_plain", "full_fp32", "MAX_EPILOGUE_STEPS", "Plan",
           "candidate_plans", "validate_plan", "SPLIT_LADDER", "compute_dtype", "plan_dtype",
           "FP8_DTYPES"]

MAX_EPILOGUE_STEPS = 8

# dtype codes shared with csrc/opope_tile.cuh
_DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int8: 3,
    torch.float8_e4m3fn: 4,
    torch.float8_e5m2: 5,
}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
# A, B, C and the epilogue operands each take any of these.
_IN_DTYPES = (torch.float32, torch.bfloat16, torch.float16) + FP8_DTYPES
# The sm90 route's operand dtypes (one for A and B): 2-byte wgmma inputs.
_SM90_DTYPES = (torch.bfloat16, torch.float16)


def compute_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype) -> torch.dtype:
    """The type the kernels compute ``A @ B`` in: the narrowest of fp16,
    bf16 and fp32 that holds both operand dtypes exactly (module
    docstring). Raises TypeError for a dtype the kernels do not take."""
    for dt in (a_dtype, b_dtype):
        if dt not in _IN_DTYPES:
            raise TypeError(f"the GEMM kernels take {_IN_DTYPES}, got {dt}")
    pair = {a_dtype, b_dtype}
    if torch.float32 in pair or pair == {torch.float16, torch.bfloat16}:
        return torch.float32
    return torch.bfloat16 if torch.bfloat16 in pair else torch.float16


def plan_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The dtype a plan is keyed by: the operands' one dtype, or None for a
    mixed pair (always the tile route)."""
    return a_dtype if a_dtype == b_dtype else None


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
        argtypes = [p, p, p, i, i, i, p, i, i, i, ep, i, i, i, p, p, p]
    else:
        fn = lib.opope_gemm_launch
        argtypes = [p, p, p, i, i, i, i, i, i, p, i, i, i, i, i, ep, p]
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
# Block (bm, bn, bk) -> (config code, stages): the tiles a plan may name.
_SM90_BLOCKS = {(bm, bn, _SM90_BK): (code, stages)
                for code, bm, bn, stages in (_SM90_DECODE, _SM90_PREFILL)}
# K split counts the tuner tries (with the heuristic's own), each kept where
# validate_plan takes it.
SPLIT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
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

    A pure function of its arguments; ``dtype`` is :func:`plan_dtype`'s
    (None for a mixed pair). The sm90 route takes bf16 or fp16 A and B of
    one dtype whose bases and row strides (``2k`` and ``2n`` bytes) are
    multiples of 16 bytes, as a TMA tensor map needs, with ``k > 0``;
    anything else (fp32, the 8-bit floats and mixed pairs first of all)
    takes the tile route. fp16 plans as bf16 does. On the sm90 route K is split
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


def _tma_ok(n: int, k: int, dtype: Optional[torch.dtype], aligned: bool) -> bool:
    """Whether TMA tensor maps describe bf16 or fp16 A [m, k] and B [k, n]
    of one dtype: row strides ``2k`` and ``2n`` bytes and bases multiples of
    16, ``k > 0``."""
    return (dtype in _SM90_DTYPES and k > 0 and (2 * k) % 16 == 0 and (2 * n) % 16 == 0
            and aligned)


def _tile_plan(m: int, n: int, k: int) -> Plan:
    bm, bn, bk = _TILE
    return Plan("tile", -1, bm, bn, bk, 2, 1, -(-m // bm), -(-n // bn), (0, k))


@functools.lru_cache(maxsize=4096)
def _unsplit_plan(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The route and tile of ``A[m,k] @ B[k,n]`` with K in one split: the
    sm90 route for bf16 or fp16 operands a TMA tensor map describes (:func:`_tma_ok`),
    the 64-row tile at ``m <= 64``, the 128-row one above; else the tile
    route. The grouped kernel (K4) takes this plan for each of its groups."""
    if not _tma_ok(n, k, dtype, aligned):
        return _tile_plan(m, n, k)
    config, bm, bn, stages = _SM90_DECODE if m <= 64 else _SM90_PREFILL
    return Plan("sm90", config, bm, bn, _SM90_BK, stages, 1, -(-m // bm), -(-n // bn), (0, k))


def validate_plan(m: int, n: int, k: int, block: Tuple[int, int, int], splits: int = 1, *,
                  dtype: torch.dtype = torch.bfloat16, aligned: bool = True) -> Plan:
    """The plan of ``A[m,k] @ B[k,n]`` on tile ``block`` (bm, bn, bk) with K
    in ``splits`` splits, or ValueError naming the hard constraint it breaks.

    ``block`` is a compiled tile: one of the sm90 route's configurations
    (64x128 and 128x128, BK 64) or the tile route's 64x64x32. The sm90 route
    takes only operands :func:`_tma_ok` passes; every split walks at least
    one BK panel; a split plan has at most ``_N_COUNTERS`` output tiles (one
    split-K counter each); the tile route never splits."""
    return _validated(m, n, k, tuple(block), splits, dtype, aligned)


@functools.lru_cache(maxsize=4096)
def _validated(m: int, n: int, k: int, block: Tuple[int, int, int], splits: int,
               dtype: torch.dtype, aligned: bool) -> Plan:
    # validate_plan's body, memoized on positional arguments: the kernel
    # checks every plan it is handed here, once per call.
    if splits < 1:
        raise ValueError(f"splits {splits} < 1")
    if block == _TILE:
        if splits != 1:
            raise ValueError(f"the tile route never splits K (splits {splits})")
        return _tile_plan(m, n, k)
    if block not in _SM90_BLOCKS:
        raise ValueError(f"block {block} is not a compiled tile: sm90 {sorted(_SM90_BLOCKS)} "
                         f"or tile {_TILE}")
    if not _tma_ok(n, k, dtype, aligned):
        raise ValueError(f"the sm90 route does not take these operands ({dtype}, K {k}, N {n}, "
                         f"bases {'' if aligned else 'not '}16-byte aligned)")
    config, stages = _SM90_BLOCKS[block]
    bm, bn, bk = block
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    panels = -(-k // bk)
    if splits > panels:
        raise ValueError(f"{splits} splits of {panels} K panels: a split would be empty")
    if splits > 1 and m_tiles * n_tiles > _N_COUNTERS:
        raise ValueError(f"{m_tiles * n_tiles} output tiles > {_N_COUNTERS} split-K counters")
    return Plan("sm90", config, bm, bn, bk, stages, splits, m_tiles, n_tiles,
                _split_bounds(k, bk, splits))


def candidate_plans(m: int, n: int, k: int, *, dtype: torch.dtype = torch.bfloat16,
                    aligned: bool = True) -> List[Plan]:
    """Every legal sm90 plan of ``A[m,k] @ B[k,n]``: each compiled sm90
    tile with each split count of :data:`SPLIT_LADDER` and the heuristic's
    own that :func:`validate_plan` takes. Empty where the sm90 route does
    not take the operands (the tile route's one plan has nothing to tune)."""
    if not _tma_ok(n, k, dtype, aligned):
        return []
    heuristic = _plan_aligned(m, n, k, dtype, aligned)
    out = []
    for block in _SM90_BLOCKS:
        for splits in sorted(set(SPLIT_LADDER) | {heuristic.splits}):
            try:
                out.append(validate_plan(m, n, k, block, splits, dtype=dtype, aligned=aligned))
            except ValueError:
                continue
    return out


# One zeroed split-K counter per output tile, kept per (device, stream):
# calls on one stream run in order and each leaves the counters it used at
# zero; calls on two streams get two buffers. The heuristic splits only when
# two or more splits of its tiles fit one wave, so it has at most
# _SM_COUNT // 2 tiles; validate_plan holds a forced split plan to the same.
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
    """What a kernel launch takes: inputs of the dtypes of the module's rule,
    a known out dtype, at most 8 epilogue steps, contiguous operands on one
    device."""
    if a.dtype not in _IN_DTYPES or b.dtype not in _IN_DTYPES:
        raise TypeError(f"{fn} takes inputs of {_IN_DTYPES}, got {a.dtype} @ {b.dtype}")
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
        if t.dtype not in _IN_DTYPES:
            raise TypeError(f"unsupported C/epilogue operand dtype {t.dtype}")


def _epilogue_struct(epilogue, epilogue_operands, shapes) -> _Epilogue:
    """The chain as the kernels' by-value struct; ``shapes`` maps each
    operand kind to the canonical shape its operand must have. An op with
    no kernel code (registered at run time) raises: the kernels' enum does
    not know it, and :mod:`.ops` runs such a chain post-hoc."""
    ep = _Epilogue()
    ep.n_steps = len(epilogue)
    it = iter(epilogue_operands)
    for s, name in enumerate(epilogue):
        op = _ep.op_def(name)
        if op.code is None:
            raise ValueError(
                f"epilogue op {name!r} has no kernel code (registered at run time); "
                f"run its chain post-hoc: an fp32 product, apply_epilogue, one cast")
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
    """Plain PyTorch ``epilogue(A @ B (+ C))``: both operands widened
    exactly to fp32, fp32 product (TF32 off), C added in fp32, the epilogue
    chain in fp32, one cast by the module's rule (:func:`.epilogue.cast_out`)."""
    out_dtype = out_dtype or a.dtype
    _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    with full_fp32():
        acc = a.float() @ b.float()
    if c is not None:
        acc = acc + c.float()
    acc = _ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
    return _ep.cast_out(acc, out_dtype)


def opope_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
    plan: Optional[Plan] = None,
) -> torch.Tensor:
    """``O = epilogue(A @ B (+ C))`` on the hand-written CUDA kernel.

    a: [M, K], b: [K, N], each fp32, bf16, fp16, e4m3 or e5m2 (the module's
    dtype rule), contiguous. c: [M, N] or [N]. ``epilogue`` names up to 8
    registered steps; ``epilogue_operands`` carries one canonical operand
    per operand-taking step (scalar ``(1,1)``, row ``(1,N)``, full
    ``(M,N)``). ``out_dtype`` is any of the five, or int8 behind
    ``requant_int8``; it defaults to ``a.dtype``. The route is
    :func:`_plan`'s, or ``plan``'s tile and split count (:func:`validate_plan`
    on these operands; ValueError where the kernel cannot take it, on the CPU
    too).
    """
    if a.device.type == "cpu":
        if plan is not None:
            _forced(plan, a.shape[0], b.shape[1], a.shape[1], a, b)
        return opope_gemm_plain(
            a, b, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    return _run(a, b, c, out_dtype, epilogue, epilogue_operands, plan=plan)


def _forced(plan: Plan, m: int, n: int, k: int, a: torch.Tensor, b: torch.Tensor) -> Plan:
    """``plan``'s knob re-planned for ``A[m,k] @ B[k,n]`` on these operands
    (their dtype and bases' alignment): one memo lookup, as :func:`_plan`;
    ValueError where illegal."""
    return _validated(m, n, k, (plan.bm, plan.bn, plan.bk), plan.splits,
                      plan_dtype(a.dtype, b.dtype),
                      a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _run(a, b, c, out_dtype, epilogue, epilogue_operands, route: Optional[str] = None,
         plan: Optional[Plan] = None):
    """One launch on the planned route, or on ``plan``'s knob; ``route``
    forces one (``"tile"`` takes every operand the kernels take; ``"sm90"``
    raises where the plan is not sm90), so a caller can time the two routes
    on the same call."""
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
    if plan is None:
        plan = _plan(m, n, k, plan_dtype(a.dtype, b.dtype), a.data_ptr(), b.data_ptr())
    else:
        plan = _forced(plan, m, n, k, a, b)
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
                _DTYPE_CODES[out_dtype], ctypes.byref(ep), plan.config,
                int(a.dtype == torch.float16), plan.splits,
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), stream,
            )
        else:
            compute = compute_dtype(a.dtype, b.dtype)
            vec_a, vec_b = _tile_vectors(compute, k, n, a, b)
            rc = _launcher("tile")(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                _DTYPE_CODES[a.dtype], _DTYPE_CODES[b.dtype], _DTYPE_CODES[compute],
                c_ptr, c_kind, c_dtype, _DTYPE_CODES[out_dtype], int(vec_a), int(vec_b),
                ctypes.byref(ep), stream,
            )
    if rc != 0:
        raise RuntimeError(f"opope_gemm {route} kernel launch failed: error {rc}")
    opope_gemm.launches += 1
    opope_gemm.launches_by_route[route] += 1
    return out


def _tile_vectors(compute: torch.dtype, k: int, n: int, a, b) -> Tuple[bool, bool]:
    """Whether the tile route reads A's and B's panels in whole vectors: a
    vector is 16 bytes of the compute type, so ``16 // compute.itemsize``
    elements of the operand's own dtype; whole vectors stay inside a row,
    each aligned to its own width, when the row length (K for A, N for B)
    is a multiple of it and the base is 16-byte aligned. A grouped call's
    group strides (M*K, K*N) are then multiples of it too."""
    vec = 16 // compute.itemsize
    return (k % vec == 0 and a.data_ptr() % 16 == 0, n % vec == 0 and b.data_ptr() % 16 == 0)


opope_gemm.launches = 0
opope_gemm.launches_by_route = {"sm90": 0, "tile": 0}
