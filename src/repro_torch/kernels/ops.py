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
:func:`register_backend` adds or replaces a backend, as the reference's
does; ``None``/``"auto"``/``"q8"`` still resolve among the four built-ins.

Epilogues: a backend registered with ``epilogue_fused=True`` (the four
built-ins) takes the chain into its call and runs it at its writeback. A
backend without it, and any chain holding an op with no kernel code (one
registered at run time, :func:`.epilogue.register_epilogue_op`), take the
**post-hoc lane**: the backend's product with ``out_dtype=float32`` and no
epilogue, :func:`.epilogue.apply_epilogue`, one cast. That is the
reference's ``_matmul_impl``/``_grouped_impl`` for its non-fused backends;
on the card the product is still K1 or K4.

Gradients: when an input of :func:`matmul` requires grad, the call runs
through :class:`_Matmul`, an autograd ``Function`` holding the reference's
four ``custom_vjp`` rules (plain product, ``[N]`` bias, full C, epilogue'd
product); :func:`grouped_matmul` runs through :class:`_GroupedMatmul`, the
reference's four grouped rules. Their backward GEMMs run on the backend's
``grad_backend`` through its ``fn`` or ``grouped_fn``, so on the card they
are K1 and K4 launches too, and they count neither into ``calls`` nor into
``gemm.calls`` (the reference's backward calls its backends directly as
well). When no input requires grad, the backend is called as it always
was. A q8-family forward trains the same way: its product runs on the
int8 kernels (K2, K5 on the card), its backward GEMMs and an epilogue'd
product's fp32 accumulator recompute on its full-precision
``grad_backend`` (K1, K4), as the reference's rules put them. A
pre-quantized activation is a serving-only lane (the reference's has no
vjp): under autograd it raises ``NotImplementedError``.

Plans (the reference's tile path, ``repro.kernels.ops._tile_for``): the
``cuda`` and ``cuda_q8`` members run K1, K4, K2 and K5 on the plan that
:func:`_tile_for` resolves, a memoized (LRU, ``_TILE_CACHE_CAP``) pure
function of backend, shape family, (M, K, N, G), element width and the
operands' 16-byte alignment, **tuned table first, heuristic second**: the
active tuning table (:mod:`repro_torch.tune`, ``REPRO_TUNE_TABLE``) names a
measured tile and K split count for this device kind, validated against the
kernel's hard constraints (an illegal entry warns and the heuristic serves);
on a miss the backend's ``tile_fn`` gives the kernel module's own ``_plan``.
With no table loaded the members skip the resolver and call the kernel
without a plan, so it runs its own ``_plan`` exactly as it did before
tuning, at no added host cost. The backward GEMMs of :class:`_Matmul` and
:class:`_GroupedMatmul` call the same members, so they resolve the same way.
:func:`tile_source` and :func:`fusion_source` report which path decided a
shape; a tuned ``fuse_epilogue=False`` sends an epilogue'd call down the
post-hoc lane. :func:`capture_shapes` records every GEMM shape its thread
routes through the registry; a call on ``meta`` tensors then computes
nothing and returns an empty result of the right shape and dtype (the
tuner's zero-FLOP harvest, :mod:`repro_torch.tune.capture`), a call on any
other device computes as always.

Telemetry (:mod:`repro_torch.obs`, host-side only): every entry-point call
counts into ``gemm.calls`` (labels ``backend``, ``family``, ``shape``
dense/grouped, ``tile`` tuned/heuristic and ``fusion`` tuned/default, or
none for a backend that does not fuse) and, under
:class:`repro_torch.obs.attr.capture_gemms`, appends a ``GemmRecord``; every
plan resolution (while a table is loaded) counts into ``tile.lookups`` (hit
or miss of the memo) and feeds the miss-streak seam (:func:`on_miss_streak`),
and
:func:`repro_torch.obs.attr.observe_step` feeds tuned shapes' roofline
fractions to the drift seam (:func:`on_util_gap`, counter
``gemm.util_gap_observations``); both default to
:func:`repro_torch.tune.retune.retune_candidate`. Inside an engine's quiet
step scope (a step key's later dispatches) a call pays none of the counters;
see :mod:`repro_torch.obs.attr`.
``REPRO_AUDIT=N`` re-executes one in N direct q8-family calls on the
backend's ``grad_backend`` (:mod:`repro_torch.obs.audit`); calls inside an
engine step, and calls that run under autograd (the reference's traced
calls under ``jax.grad``), are never audited.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch import obs as _obs
from repro_torch.obs import attr as _attr

from . import epilogue as _epi
from .opope_gemm import Plan, opope_gemm, opope_gemm_plain
from .opope_gemm import _plan_aligned as _k1_plan
from .opope_gemm import validate_plan as _k1_validate_plan
from .opope_grouped import opope_gemm_grouped, opope_gemm_grouped_plain
from .opope_grouped import _plan_aligned as _k4_plan
from .opope_grouped import validate_plan as _k4_validate_plan
from repro_torch.quant import backends as _q8
from repro_torch.quant.opope_q8 import _plan_aligned as _k2_plan
from repro_torch.quant.opope_q8 import _plan_grouped_aligned as _k5_plan
from repro_torch.quant.opope_q8 import validate_plan as _q8_validate_plan
from repro_torch.quant.quantize import QuantizedTensor

__all__ = [
    "Backend",
    "register_backend",
    "registered_backends",
    "backend",
    "resolve_backend",
    "family_of",
    "grad_backend_of",
    "reset_counts",
    "matmul",
    "linear",
    "grouped_matmul",
    "epilogue_capable",
    "fusion_source",
    "tunable_backends",
    "tile_for",
    "tile_source",
    "heuristic_tile",
    "tile_cache_info",
    "tile_cache_stats",
    "reset_tile_cache_stats",
    "on_miss_streak",
    "on_util_gap",
    "clear_tile_cache",
    "capture_shapes",
]


@dataclasses.dataclass
class Backend:
    """One GEMM backend: ``fn(a, b, c, out_dtype=)`` on 2-D operands and
    ``grouped_fn`` (the same signature, None for a backend without one) on
    [G, M, K] @ [G, K, N], each taking ``epilogue=`` and
    ``epilogue_operands=`` too where ``epilogue_fused``; the device type it
    runs on (None for any), its numerics family (``"fp"``/``"q8"``), the
    full-precision backend its gradients will run on (``grad_backend``, for
    quantized members), its plan heuristic and validator (``tile_fn``, None
    for a backend with no tile knob), and its call counts."""

    name: str
    fn: Callable[..., torch.Tensor]
    grouped_fn: Optional[Callable[..., torch.Tensor]]
    device_type: Optional[str]
    family: str = "fp"
    grad_backend: Optional[str] = None
    epilogue_fused: bool = False
    tile_fn: Optional[Callable[..., Plan]] = None
    calls: int = 0
    grouped_calls: int = 0


# The dtype whose plans an operand width keys (:func:`_fp_tile`).
_ITEMSIZE_DTYPES = {4: torch.float32, 2: torch.bfloat16, 1: torch.float8_e4m3fn}


def _fp_tile(shape_family: str, m: int, k: int, n: int, *, itemsize: int,
             aligned: bool = True, block=None, splits: int = 1) -> Plan:
    """The ``cuda`` backend's ``tile_fn``: K1's plan (``"dense"``) or K4's
    (``"grouped"``) for operands of ``itemsize`` bytes: bf16's plans at 2
    (fp16 shares them), fp32's at 4 and the 8-bit floats' at 1 (e4m3 and
    e5m2 share them; like fp32's, only the tile route). Without ``block``
    the kernel module's heuristic; with one, the plan of that tile and split
    count, validated (ValueError where the kernel cannot take it)."""
    dtype = _ITEMSIZE_DTYPES[itemsize]
    grouped = shape_family == "grouped"
    if block is None:
        return (_k4_plan if grouped else _k1_plan)(m, n, k, dtype, aligned)
    validate = _k4_validate_plan if grouped else _k1_validate_plan
    return validate(m, n, k, tuple(block), splits, dtype=dtype, aligned=aligned)


def _q8_tile(shape_family: str, m: int, k: int, n: int, *, itemsize: int = 1,
             aligned: bool = True, block=None, splits: int = 1) -> Plan:
    """The ``cuda_q8`` backend's ``tile_fn``: K2's plan (``"dense"``) or
    K5's (``"grouped"``) on the int8 operands, as :func:`_fp_tile`."""
    grouped = shape_family == "grouped"
    if block is None:
        return (_k5_plan if grouped else _k2_plan)(m, n, k, aligned)
    return _q8_validate_plan(m, n, k, tuple(block), splits, aligned=aligned, grouped=grouped)


def _planned(name: str, kernel: Callable[..., torch.Tensor], grouped: bool, q8: bool
             ) -> Callable[..., torch.Tensor]:
    """The member of backend ``name`` that runs ``kernel`` on the plan
    :func:`_tile_for` resolves for its operands (the reference's
    ``_pallas_fn``). With no table loaded it passes no plan: the kernel runs
    its own ``_plan``, the path before tuning. A q8 member quantizes A and B
    into fresh (aligned) int8 tensors, so only a pre-quantized A's own
    values set its alignment. An empty product plans nothing (the kernels
    return before planning)."""
    shape_family = "grouped" if grouped else "dense"

    def run(a, b, c=None, **kw):
        if _tuning_table() is None:
            return kernel(a, b, c, **kw)
        x = getattr(a, "q", a)
        if q8:
            aligned, itemsize = x is a or x.data_ptr() % 16 == 0, 1
        else:
            aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            # A mixed pair runs the tile route alone: fp32's width keys it.
            itemsize = a.element_size() if a.dtype == b.dtype else 4
        m, k, n = x.shape[-2], x.shape[-1], b.shape[-1]
        groups = x.shape[0] if grouped else 0
        plan = None
        if m and n and (groups or not grouped):
            plan = _tile_for(m, k, n, itemsize, shape_family, groups, name, aligned=aligned)
        return kernel(a, b, c, plan=plan, **kw)

    return run


_REGISTRY: Dict[str, Backend] = {
    "cuda": Backend("cuda", _planned("cuda", opope_gemm, False, False),
                    _planned("cuda", opope_gemm_grouped, True, False), "cuda",
                    epilogue_fused=True, tile_fn=_fp_tile),
    "torch": Backend("torch", opope_gemm_plain, opope_gemm_grouped_plain, None,
                     epilogue_fused=True),
    "cuda_q8": Backend("cuda_q8", _planned("cuda_q8", _q8.cuda_q8, False, True),
                       _planned("cuda_q8", _q8.cuda_q8_grouped, True, True), "cuda",
                       family="q8", grad_backend="cuda", epilogue_fused=True, tile_fn=_q8_tile),
    "torch_q8": Backend("torch_q8", _q8.torch_q8, _q8.torch_q8_grouped, None,
                        family="q8", grad_backend="torch", epilogue_fused=True),
}


def register_backend(
    name: str,
    fn: Callable[..., torch.Tensor],
    *,
    grouped: Optional[Callable[..., torch.Tensor]] = None,
    device_type: Optional[str] = None,
    family: str = "fp",
    grad_backend: Optional[str] = None,
    epilogue_fused: bool = False,
    tile_fn: Optional[Callable[..., Plan]] = None,
) -> None:
    """Register (or replace) a GEMM backend, as the reference's
    ``register_backend``.

    ``fn(a, b, c, out_dtype=)`` computes ``a @ b (+ c)`` with an fp32
    accumulator and one cast (``c`` None, an ``[N]`` row or a full
    ``[M, N]``); ``grouped`` is its [G, M, K] @ [G, K, N] member (``c`` None,
    ``[G, N]`` or ``[G, M, N]``), without which :func:`grouped_matmul` on
    this backend raises. ``device_type`` is the one device type it takes
    tensors on (None: any). ``family`` names its numerics; ``grad_backend``
    the backend its backward GEMMs run on (itself when None).
    ``epilogue_fused=True`` declares that both take ``epilogue=`` and
    ``epilogue_operands=`` and run the chain at their writeback; every
    other backend gets the post-hoc lane. ``tile_fn(shape_family, m, k, n,
    *, itemsize, aligned=True, block=None, splits=1) -> Plan`` is the plan
    heuristic (without ``block``) and validator (with one: ValueError where
    the kernel cannot take that tile and split count); registering one
    makes the backend tunable, its members resolving plans through
    :func:`_tile_for`, tuned table first. The reference's ``available`` and
    ``fallback`` have no counterpart: there are no chains."""
    if not callable(fn):
        raise TypeError(f"backend fn for {name!r} is not callable")
    if grouped is not None and not callable(grouped):
        raise TypeError(f"grouped member for {name!r} is not callable")
    if tile_fn is not None and not callable(tile_fn):
        raise TypeError(f"tile_fn for {name!r} is not callable")
    _REGISTRY[name] = Backend(name, fn, grouped, device_type, family=family,
                              grad_backend=grad_backend, epilogue_fused=epilogue_fused,
                              tile_fn=tile_fn)


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
    ``"cuda_q8"`` or ``"torch_q8"`` the same way (registered backends never
    enter these picks); a named backend that cannot take tensors on
    ``device`` raises (there is no fallback)."""
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


def grad_backend_of(name: str) -> str:
    """Backend the backward GEMMs of ``name`` run on (itself by default)."""
    be = _REGISTRY.get(name)
    return be.grad_backend if be is not None and be.grad_backend else name


# ---------------------------------------------------------------------------
# Plan resolution: tuned table first, heuristic second (the reference's
# ``_tile_for``), with its telemetry and retune seams
# ---------------------------------------------------------------------------

# Cap on the plan memo: a serving process sees an unbounded stream of
# (prompt bucket x layer) shapes; LRU eviction bounds it.
_TILE_CACHE_CAP = 512

# The loaded tuning table (repro_torch.tune.table.TuningTable or None),
# read once on the first resolution and dropped by clear_tile_cache().
_TUNE_STATE: Dict[str, object] = {"loaded": False, "table": None}

# (backend, shape_family, m, k, n, groups, itemsize): the key the retune
# seams receive, as the reference's.
TileKey = Tuple[Optional[str], str, int, int, int, int, int]


def _tuning_table():
    if not _TUNE_STATE["loaded"]:
        _TUNE_STATE["loaded"] = True
        from repro_torch.tune.table import load_active_table

        _TUNE_STATE["table"] = load_active_table()
    return _TUNE_STATE["table"]


def _tuned_tile(backend: Optional[str], family: str, m: int, k: int, n: int, groups: int,
                itemsize: int, aligned: bool = True, warn: bool = True) -> Optional[Plan]:
    """The tuning table's plan for this cell, validated by the backend's
    ``tile_fn``; None without a table, an entry, a tile knob, or aligned
    operands (the tuner measures aligned ones). An entry the kernel cannot
    take (an uncompiled tile, a split over the counters, a split of K4 or
    K5, operands the route refuses) warns and gives None: the table is
    untrusted input."""
    be = _REGISTRY.get(backend) if backend else None
    if be is None or be.tile_fn is None or not aligned:
        return None
    table = _tuning_table()
    if table is None:
        return None
    entry = table.lookup_entry(backend=backend, shape_family=family, m=m, k=k, n=n,
                               g=groups, itemsize=itemsize)
    if entry is None:
        return None
    try:
        return be.tile_fn(family, m, k, n, itemsize=itemsize, aligned=True,
                          block=entry.block, splits=entry.splits)
    except ValueError as e:
        if warn:
            warnings.warn(
                f"tuning-table entry {entry.block} x {entry.splits} splits for backend "
                f"{backend!r} ({family} {m}x{k}x{n}, g={groups}) violates kernel "
                f"constraints ({e}); using the heuristic instead",
                RuntimeWarning, stacklevel=3,
            )
        return None


# Resettable lookup telemetry (the LRU's own totals cannot be zeroed without
# dropping the memo): hits and misses feed ``tile.lookups``, the consecutive
# miss streak the on_miss_streak seam.
_TILE_STATS_LOCK = threading.Lock()
_TILE_STATS = {"hits": 0, "misses": 0, "streak": 0}
_MISS_STREAK_HOOK: Dict[str, object] = {"fn": None, "threshold": 8}


def on_miss_streak(callback: Optional[Callable[[TileKey, int], None]] = None, *,
                   threshold: int = 8) -> None:
    """Register the sustained plan-memo-miss callback (the auto-retune seam).

    ``callback(key, streak)`` fires when ``threshold`` consecutive plan
    resolutions miss the memo, and again at every further multiple while the
    streak lasts; ``key`` is ``(backend, shape_family, m, k, n, groups,
    itemsize)``. ``None`` restores the default hook
    (:func:`repro_torch.tune.retune.retune_candidate`: count and log, never
    retune). Exceptions in the callback are swallowed."""
    if threshold < 1:
        raise ValueError("miss-streak threshold must be >= 1")
    _MISS_STREAK_HOOK["fn"] = callback
    _MISS_STREAK_HOOK["threshold"] = int(threshold)


def _default_miss_streak(key: TileKey, streak: int) -> None:
    from repro_torch.tune.retune import retune_candidate

    retune_candidate(key, streak)


def _note_tile_lookup(missed: bool, key: TileKey) -> None:
    with _TILE_STATS_LOCK:
        if missed:
            _TILE_STATS["misses"] += 1
            _TILE_STATS["streak"] += 1
            streak = _TILE_STATS["streak"]
        else:
            _TILE_STATS["hits"] += 1
            _TILE_STATS["streak"] = 0
            streak = 0
    if _obs.enabled() and not _attr.step_quiet():
        _obs.counter("tile.lookups", result="miss" if missed else "hit").inc()
    if missed:
        thr = int(_MISS_STREAK_HOOK["threshold"])  # type: ignore[arg-type]
        if streak >= thr and streak % thr == 0:
            fn = _MISS_STREAK_HOOK["fn"] or _default_miss_streak
            try:
                fn(key, streak)  # type: ignore[operator]
            except Exception:
                pass


# The drift sibling: shapes the table covers whose live roofline fraction
# (obs.attr.observe_step) keeps landing below a share of their own best.
_UTIL_GAP_HOOK: Dict[str, object] = {"fn": None, "threshold": 0.5, "streak": 4}
_UTIL_STREAKS: Dict[TileKey, int] = {}
_UTIL_BEST: Dict[TileKey, float] = {}


def on_util_gap(callback: Optional[Callable[[TileKey, int, float], None]] = None, *,
                threshold: float = 0.5, streak: int = 4) -> None:
    """Register the tuned-but-underperforming callback (the drift-retune seam).

    Fed by :func:`repro_torch.obs.attr.observe_step`: each attributed
    execution of a *tuned* GEMM class scores a roofline fraction; when a
    key's fraction falls below ``threshold`` x its own best for ``streak``
    consecutive observations, ``callback(key, streak_len, fraction)`` fires
    (and at every further multiple). Relative to its own best, not absolute:
    on the card the fraction is host wall time apportioned, so drift is a
    shape doing worse than itself. ``None`` restores the default hook
    (``retune_candidate(..., reason="util_gap")``); exceptions are swallowed;
    heuristic-planned observations only reset the streak."""
    if not (0.0 < threshold <= 1.0):
        raise ValueError("util-gap threshold must be in (0, 1]")
    if streak < 1:
        raise ValueError("util-gap streak must be >= 1")
    _UTIL_GAP_HOOK["fn"] = callback
    _UTIL_GAP_HOOK["threshold"] = float(threshold)
    _UTIL_GAP_HOOK["streak"] = int(streak)


def _default_util_gap(key: TileKey, streak: int, fraction: float) -> None:
    from repro_torch.tune.retune import retune_candidate

    retune_candidate(key, streak, reason="util_gap")


def _note_util_observation(key: TileKey, fraction: float, source: str) -> None:
    """One attributed utilization observation for ``key`` (obs.attr calls
    this). Only tuned plans advance the gap streak."""
    if source != "tuned":
        _UTIL_STREAKS.pop(key, None)
        return
    with _TILE_STATS_LOCK:
        best = _UTIL_BEST.get(key, 0.0)
        if fraction > best:
            _UTIL_BEST[key] = best = fraction
        thr = float(_UTIL_GAP_HOOK["threshold"])  # type: ignore[arg-type]
        if best > 0.0 and fraction < thr * best:
            streak = _UTIL_STREAKS.get(key, 0) + 1
            _UTIL_STREAKS[key] = streak
        else:
            _UTIL_STREAKS.pop(key, None)
            return
    if _obs.enabled():
        _obs.counter("gemm.util_gap_observations").inc()
    need = int(_UTIL_GAP_HOOK["streak"])  # type: ignore[arg-type]
    if streak >= need and streak % need == 0:
        fn = _UTIL_GAP_HOOK["fn"] or _default_util_gap
        try:
            fn(key, streak, fraction)  # type: ignore[operator]
        except Exception:
            pass


def _heuristic(backend: Optional[str], family: str, m: int, k: int, n: int, itemsize: int,
               aligned: bool) -> Plan:
    """The backend's ``tile_fn`` heuristic; a backend with no tile knob
    gets the ``cuda`` members' (the reference's default-block-shape rule)."""
    be = _REGISTRY.get(backend) if backend else None
    tile_fn = be.tile_fn if be is not None and be.tile_fn is not None else _fp_tile
    return tile_fn(family, m, k, n, itemsize=itemsize, aligned=aligned)


CacheInfo = collections.namedtuple("CacheInfo", "hits misses maxsize currsize")


class _TileResolver:
    """The memoized plan resolver behind :func:`_tile_for`: an LRU over
    (m, k, n, itemsize, shape family, groups, backend, aligned) whose every
    call notes hit or miss (:func:`tile_cache_stats`, ``tile.lookups``, the
    miss streak). A grouped GEMM never shares a slot, or a table entry, with
    a dense one of the same (M, K, N). Tuned table first, the backend's
    ``tile_fn`` heuristic second. Every GEMM a member runs resolves here, so
    a hit is a dict lookup (no ``lru_cache`` bookkeeping to read back)."""

    def __init__(self, maxsize: int) -> None:
        self.maxsize = maxsize
        self._memo: "collections.OrderedDict[tuple, Plan]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._hits = self._misses = 0

    @staticmethod
    def _resolve(m: int, k: int, n: int, itemsize: int, family: str, groups: int,
                 backend: Optional[str], aligned: bool) -> Plan:
        tuned = _tuned_tile(backend, family, m, k, n, groups, itemsize, aligned)
        if tuned is not None:
            return tuned
        return _heuristic(backend, family, m, k, n, itemsize, aligned)

    def __call__(self, m: int, k: int, n: int, itemsize: int, family: str = "dense",
                 groups: int = 0, backend: Optional[str] = None, *,
                 aligned: bool = True) -> Plan:
        key = (m, k, n, itemsize, family, groups, backend, aligned)
        with self._lock:
            plan = self._memo.get(key)
            if plan is not None:
                self._memo.move_to_end(key)
                self._hits += 1
        missed = plan is None
        if missed:
            plan = self._resolve(*key)
            with self._lock:
                self._memo[key] = plan
                if len(self._memo) > self.maxsize:
                    self._memo.popitem(last=False)
                self._misses += 1
        _note_tile_lookup(missed, (backend, family, m, k, n, groups, itemsize))
        return plan

    def cache_info(self) -> CacheInfo:
        with self._lock:
            return CacheInfo(self._hits, self._misses, self.maxsize, len(self._memo))

    def cache_clear(self) -> None:
        with self._lock:
            self._memo.clear()
            self._hits = self._misses = 0


_tile_for = _TileResolver(maxsize=_TILE_CACHE_CAP)


def tile_cache_info():
    """CacheInfo of the plan memo (lifetime totals; currsize never exceeds
    the cap). For resettable counts use :func:`tile_cache_stats`."""
    return _tile_for.cache_info()


def tile_cache_stats() -> Dict[str, int]:
    """``hits``/``misses`` since :func:`reset_tile_cache_stats`, the current
    ``miss_streak``, and the memo's ``currsize``/``maxsize``."""
    info = _tile_for.cache_info()
    with _TILE_STATS_LOCK:
        return {"hits": _TILE_STATS["hits"], "misses": _TILE_STATS["misses"],
                "miss_streak": _TILE_STATS["streak"], "currsize": info.currsize,
                "maxsize": info.maxsize}


def reset_tile_cache_stats() -> None:
    """Zero the lookup counts, the miss streak and the util-gap state,
    keeping the memo warm."""
    with _TILE_STATS_LOCK:
        _TILE_STATS.update(hits=0, misses=0, streak=0)
        _UTIL_STREAKS.clear()
        _UTIL_BEST.clear()


def clear_tile_cache() -> None:
    """Drop the plan memo, the fusion and label memos and the loaded
    table: the next resolution re-reads ``REPRO_TUNE_TABLE`` (or the
    default path). The miss streak resets too."""
    _tile_for.cache_clear()
    _fusion_for.cache_clear()
    _labels.cache_clear()
    _TUNE_STATE["loaded"] = False
    _TUNE_STATE["table"] = None
    with _TILE_STATS_LOCK:
        _TILE_STATS["streak"] = 0


def tunable_backends() -> List[str]:
    """Registered backends with a tile knob (a ``tile_fn``)."""
    return [name for name, be in _REGISTRY.items() if be.tile_fn is not None]


def _tile_itemsize(backend: str, dtype: torch.dtype) -> int:
    """Element width plan selection keys on: q8 backends stream int8."""
    be = _REGISTRY.get(backend)
    if be is not None and be.family == "q8":
        return 1
    return dtype.itemsize


def tile_for(backend: str, m: int, k: int, n: int, *, groups: int = 0,
             dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The plan ``backend`` would run this GEMM on, for aligned operands
    (``groups=0``: dense; ``groups>0``: grouped, (m, k, n) per group)."""
    family = "grouped" if groups else "dense"
    return _tile_for(m, k, n, _tile_itemsize(backend, dtype), family, groups, backend)


def tile_source(backend: str, m: int, k: int, n: int, *, groups: int = 0,
                dtype: torch.dtype = torch.bfloat16) -> str:
    """``"tuned"`` if the tuning table decides this shape's plan, else
    ``"heuristic"`` (also for backends with no tile knob)."""
    family = "grouped" if groups else "dense"
    tuned = _tuned_tile(backend, family, m, k, n, groups, _tile_itemsize(backend, dtype))
    return "tuned" if tuned is not None else "heuristic"


def heuristic_tile(backend: str, m: int, k: int, n: int, *, groups: int = 0,
                   dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The backend's ``tile_fn`` plan, bypassing any table (the tuner's
    always-measured baseline)."""
    family = "grouped" if groups else "dense"
    return _heuristic(backend, family, m, k, n, _tile_itemsize(backend, dtype), True)


def epilogue_capable(name: str) -> bool:
    """Whether ``name``'s members run an epilogue at their writeback
    (``epilogue_fused``); every other backend takes the post-hoc lane."""
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(
            f"unknown matmul backend {name!r}; registered: {registered_backends()}"
        )
    return be.epilogue_fused


def _fusion_verdict(backend: Optional[str], family: str, m: int, k: int, n: int,
                    groups: int, itemsize: int) -> Optional[bool]:
    table = _tuning_table()
    if table is None:
        return None
    return table.lookup_fusion(backend=backend, shape_family=family, m=m, k=k, n=n,
                               g=groups, itemsize=itemsize)


@functools.lru_cache(maxsize=_TILE_CACHE_CAP)
def _fusion_for(m: int, k: int, n: int, itemsize: int, family: str = "dense",
                groups: int = 0, backend: Optional[str] = None) -> bool:
    """Memoized fuse-or-not verdict for an epilogue-capable backend: the
    table's measured ``fuse_epilogue`` first, fuse by default second."""
    verdict = _fusion_verdict(backend, family, m, k, n, groups, itemsize)
    return True if verdict is None else bool(verdict)


def fusion_source(backend: str, m: int, k: int, n: int, *, groups: int = 0,
                  dtype: torch.dtype = torch.bfloat16) -> str:
    """``"tuned"`` if the tuning table decides fused-vs-post-hoc for this
    shape on this backend, else ``"default"``."""
    family = "grouped" if groups else "dense"
    verdict = _fusion_verdict(backend, family, m, k, n, groups,
                              _tile_itemsize(backend, dtype))
    return "default" if verdict is None else "tuned"


@functools.lru_cache(maxsize=_TILE_CACHE_CAP)
def _labels(backend: str, shape_family: str, m: int, k: int, n: int, groups: int,
            itemsize: int) -> Tuple[str, str]:
    """The ``tile`` and ``fusion`` labels of ``gemm.calls`` for a cell,
    memoized (an illegal entry warns once, from the resolver, not per call)."""
    tile = "tuned" if _tuned_tile(backend, shape_family, m, k, n, groups, itemsize,
                                  warn=False) is not None else "heuristic"
    fusion = "none"
    if _REGISTRY[backend].epilogue_fused:
        verdict = _fusion_verdict(backend, shape_family, m, k, n, groups, itemsize)
        fusion = "default" if verdict is None else "tuned"
    return tile, fusion


def _fused_here(be: Backend, a, b, grouped: bool) -> bool:
    """Whether ``be`` fuses the chain for these operands (the tuned verdict;
    with no table loaded, fused)."""
    if _tuning_table() is None:
        return True
    x = getattr(a, "q", a)
    return _fusion_for(x.shape[-2], x.shape[-1], b.shape[-1], _tile_itemsize(be.name, x.dtype),
                       "grouped" if grouped else "dense", x.shape[0] if grouped else 0,
                       be.name)


# ---------------------------------------------------------------------------
# Shape capture (the tuner's workload harvest)
# ---------------------------------------------------------------------------

# Each thread's open captures: a harvest in one thread neither records nor
# changes another thread's calls.
_SHAPE_CAPTURE = threading.local()


def _captures() -> List[list]:
    return getattr(_SHAPE_CAPTURE, "stack", ())


class capture_shapes:
    """Record every GEMM shape this thread routes through the registry inside
    the block, as ``(shape_family, m, k, n, g, dtype_name)`` tuples in call
    order (duplicates included). A call on ``meta`` tensors computes
    nothing: it returns an empty result of the right shape and dtype, so
    parameters and inputs on ``torch.device("meta")`` harvest a model's GEMM
    workload with zero FLOPs (the port's ``jax.eval_shape``). A call on any
    other device is recorded and computes as always. Nestable."""

    def __enter__(self) -> List[Tuple[str, int, int, int, int, str]]:
        self._records: List[Tuple[str, int, int, int, int, str]] = []
        if not hasattr(_SHAPE_CAPTURE, "stack"):
            _SHAPE_CAPTURE.stack = []
        _SHAPE_CAPTURE.stack.append(self._records)
        return self._records

    def __exit__(self, *exc):
        stack = _SHAPE_CAPTURE.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self._records:
                del stack[i]
                break
        return False


def _record_shape(family: str, m: int, k: int, n: int, g: int, dtype: torch.dtype) -> None:
    rec = (family, int(m), int(k), int(n), int(g), _dtype_name(dtype))
    for records in _captures():
        records.append(rec)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _serving_only(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"a pre-quantized activation ({name!r}) is a serving-only lane with no "
        f"backward, as the reference's; call it under torch.no_grad() or on "
        f"inputs that do not require grad"
    )


def _member(be: Backend, grouped: bool) -> Callable[..., torch.Tensor]:
    """The backend's 2-D or grouped function; a backend registered without
    a grouped member raises (there is no fallback)."""
    if not grouped:
        return be.fn
    if be.grouped_fn is None:
        raise ValueError(f"matmul backend {be.name!r} has no grouped member")
    return be.grouped_fn


def _run(be: Backend, a, b, c, out_dtype, steps, ep_ops, grouped: bool = False):
    """``epilogue(a @ b (+ c))`` on ``be``: the chain at the backend's
    writeback where it fuses, every op has a kernel code and no tuned
    ``fuse_epilogue=False`` says otherwise for the shape, else the post-hoc
    lane (an fp32 product, the chain, one cast). ``c`` is None whenever
    ``steps`` is not empty (the entry points fold it in)."""
    fn = _member(be, grouped)
    if not steps:
        return fn(a, b, c, out_dtype=out_dtype)
    if be.epilogue_fused and _epi.fusable(steps) and _fused_here(be, a, b, grouped):
        return fn(a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ep_ops)
    acc = fn(a, b, c, out_dtype=torch.float32)
    return _epi.cast_out(_epi.apply_epilogue(acc, steps, ep_ops), out_dtype)


def _bwd_gemm(fn, x: torch.Tensor, y: torch.Tensor, out_dtype) -> torch.Tensor:
    """One backward GEMM ``x @ y`` on ``fn``. Operands of two dtypes (the
    fp32 cotangent of an epilogue'd product against a bf16 operand) are
    both cast to the wider one, exactly, as the reference's ``jnp.dot``
    promotes them: the kernels take one input dtype. Transposed operands
    are copied contiguous (the kernels take contiguous operands), cast and
    copied in one pass: a transposed grok-1-314b expert weight in fp32 is
    6.4 GB."""
    dt = torch.promote_types(x.dtype, y.dtype)

    def operand(t):
        # .to returns a same-dtype tensor as it is, whatever its layout.
        return t.to(dt, memory_format=torch.contiguous_format).contiguous()

    return fn(operand(x), operand(y), None, out_dtype=out_dtype)


def _forward(ctx, grouped, name, out_dtype, steps, a, b, c, ep_ops):
    ctx.name, ctx.steps = name, steps
    ctx.c_meta = None if c is None else (c.dtype, c.shape)
    ctx.save_for_backward(a, b, *ep_ops)
    return _run(_REGISTRY[name], a, b, c, out_dtype, steps, ep_ops, grouped)


def _backward(ctx, g, grouped):
    """The reference's rules for a product of :func:`_forward`; the GEMMs
    on the grad backend's 2-D or grouped member."""
    a, b, *ep_ops = ctx.saved_tensors
    need_a, need_b, need_c = ctx.needs_input_grad[3:6]
    need_ops = ctx.needs_input_grad[6:]
    fn = _member(_REGISTRY[grad_backend_of(ctx.name)], grouped)
    g = g.contiguous()
    d_ops = [None] * len(ep_ops)
    if ctx.steps:
        acc = fn(a, b, None, out_dtype=torch.float32)
        g, d = _epi.epilogue_vjp(ctx.steps, tuple(ep_ops), acc, g)
        d_ops = [x.to(o.dtype).reshape(o.shape) if need else None
                 for x, o, need in zip(d, ep_ops, need_ops)]
    da = _bwd_gemm(fn, g, b.transpose(-1, -2), a.dtype) if need_a else None
    db = _bwd_gemm(fn, a.transpose(-1, -2), g, b.dtype) if need_b else None
    dc = None
    if need_c:
        c_dtype, c_shape = ctx.c_meta
        # A bias row ([N], or [G, N] for a grouped product) enters every
        # accumulator row once; a full C enters linearly.
        bias = len(c_shape) == a.ndim - 1
        dc = (g.float().sum(-2) if bias else g).to(c_dtype).reshape(c_shape)
    return (None, None, None, da, db, dc, *d_ops)


class _Matmul(torch.autograd.Function):
    """``epilogue(a @ b (+ c))`` on one backend, differentiable, with the
    reference's rules (``_matmul_nc_bwd``, ``_matmul_bias_bwd``,
    ``_matmul_bwd`` and ``_matmul_ep_bwd`` of :mod:`repro.kernels.ops`):

    * ``dA = g @ B^T`` and ``dB = A^T @ g``, cast to A's and B's dtypes;
    * an ``[N]`` bias: ``dbias = g.sum(0)``; a full C: ``dC = g``;
    * with an epilogue (C is then its first step): the fp32 accumulator is
      recomputed (one more GEMM), :func:`.epilogue.epilogue_vjp` gives its
      fp32 cotangent ``g_acc`` and each operand's, and the two GEMMs above
      run on ``g_acc``.

    Every GEMM of the backward runs on the ``grad_backend`` of the forward's
    backend. A and B^T are made contiguous for it (the kernels take
    contiguous operands)."""

    @staticmethod
    def forward(ctx, name, out_dtype, steps, a, b, c, *ep_ops):
        return _forward(ctx, False, name, out_dtype, steps, a, b, c, ep_ops)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, g, False)


class _GroupedMatmul(torch.autograd.Function):
    """``O[g] = epilogue(A[g] @ B[g] (+ C[g]))``, differentiable, with the
    reference's grouped rules (``_grouped_nc``, ``_grouped_bias``,
    ``_grouped_c`` and ``_grouped_ep`` of :mod:`repro.kernels.ops`):
    ``dA[g] = dO[g] @ B[g]^T`` and ``dB[g] = A[g]^T @ dO[g]``, a ``[G, N]``
    bias gets ``g.sum(1)``, a full C gets ``g``, and an epilogue'd product
    recomputes its fp32 accumulator as one more grouped GEMM and runs the
    two GEMMs on ``g_acc``. Every backward GEMM runs on the grad backend's
    ``grouped_fn`` (on the card: K4, on ``[G, N, K]`` and ``[G, K, M]``
    copies of the transposed operands)."""

    @staticmethod
    def forward(ctx, name, out_dtype, steps, a, b, c, *ep_ops):
        return _forward(ctx, True, name, out_dtype, steps, a, b, c, ep_ops)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, g, True)


def _note_gemm_call(
    shape_family: str, backend: str, m: int, k: int, n: int, groups: int,
    dtype, b_dtype, out_dtype,
) -> None:
    """Count one GEMM entry-point call into ``gemm.calls`` and, while a
    capture is active, record it for utilization attribution. Host-side
    only; a no-op with telemetry off or inside a quiet step scope."""
    if not _obs.enabled() or _attr.step_quiet():
        return
    be = _REGISTRY[backend]
    family = be.family
    itemsize = 1 if family == "q8" else dtype.itemsize
    if _tuning_table() is None:
        tile, fusion = "heuristic", "default" if be.epilogue_fused else "none"
    else:
        tile, fusion = _labels(backend, shape_family, int(m), int(k), int(n), int(groups),
                               itemsize)
    _obs.counter(
        "gemm.calls", backend=backend, family=family, shape=shape_family,
        tile=tile, fusion=fusion,
    ).inc()
    if _attr.capturing():
        _attr.record_call(_attr.GemmRecord(
            shape_family=shape_family, backend=backend, family=family,
            m=int(m), k=int(k), n=int(n), g=int(groups),
            a_dtype=_dtype_name(dtype), b_dtype=_dtype_name(b_dtype),
            out_dtype=_dtype_name(out_dtype), tile_source=tile,
            tile_key=(backend, shape_family, int(m), int(k), int(n), int(groups), itemsize),
        ))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _maybe_audit_gemm(kind, backend, out, ref_fn, m, k, n, g=0) -> None:
    """Shadow-audit hook for quantized-family entry-point calls: cheap
    rejections first (telemetry off, fp family, inside an engine step), the
    sampling gate in :mod:`repro_torch.obs.audit`."""
    if not _obs.enabled() or _attr.in_step():
        return
    family = _REGISTRY[backend].family
    if family == "fp":
        return
    _obs.audit.maybe_audit_gemm(
        kind=kind, backend=backend, family=family, out=out, ref_fn=ref_fn,
        m=int(m), k=int(k), n=int(n), g=int(g),
    )


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
    if _captures():
        _record_shape("dense", m, arr.shape[-1], n, 0, arr.dtype)
        if arr.device.type == "meta":
            return torch.empty((*batch_shape, n), dtype=out_dtype, device=arr.device)
    _note_gemm_call("dense", name, m, arr.shape[-1], n, 0, arr.dtype, b.dtype, out_dtype)
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
    b2 = b.contiguous()
    if _needs_grad(a2, getattr(a, "scale", None), b2, c, *ep_ops):
        if pre_q:
            raise _serving_only(name)
        # Not audited: the reference never audits a call under jax.grad.
        out = _Matmul.apply(name, out_dtype, steps, a2, b2, c, *ep_ops)
    else:
        out = _run(be, a2, b2, c, out_dtype, steps, ep_ops)
        if not pre_q:  # a pre-quantized A has no fp twin to audit against
            _maybe_audit_gemm(
                "dense", name, out,
                lambda: _run(_REGISTRY[grad_backend_of(name)], a2, b2, c, out_dtype, steps,
                             ep_ops),
                m, a2.shape[1], n)
    return out if len(batch_shape) == 1 else out.reshape(*batch_shape, n)


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
    (A per (group, row), B per (group, column)). Under autograd the call
    runs through :class:`_GroupedMatmul`, whose backward runs on the
    backend's ``grad_backend``, and is not audited.
    """
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(
            f"grouped_matmul wants a [G, M, K] @ [G, K, N]; got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    out_dtype = out_dtype or a.dtype
    name = resolve_backend(backend, a.device)
    g, m, n = a.shape[0], a.shape[1], b.shape[2]
    if _captures():
        _record_shape("grouped", m, a.shape[2], n, g, a.dtype)
        if a.device.type == "meta":
            return torch.empty((g, m, n), dtype=out_dtype, device=a.device)
    _note_gemm_call("grouped", name, m, a.shape[2], n, g, a.dtype, b.dtype, out_dtype)
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
    a2, b2, c2 = a.contiguous(), b.contiguous(), None if c is None else c.contiguous()
    if _needs_grad(a2, b2, c2, *ep_ops):
        return _GroupedMatmul.apply(name, out_dtype, steps, a2, b2, c2, *ep_ops)
    out = _run(be, a2, b2, c2, out_dtype, steps, ep_ops, grouped=True)
    _maybe_audit_gemm(
        "grouped", name, out,
        lambda: _run(_REGISTRY[grad_backend_of(name)], a2, b2, c2, out_dtype, steps, ep_ops,
                     grouped=True),
        m, a.shape[2], n, g=g)
    return out
