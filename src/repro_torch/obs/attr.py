"""Live utilization attribution: from "GEMMs ran" to "GEMMs ran *this well*".

The port of :mod:`repro.obs.attr`. Attribution works at the granularity a
real wall-clock bracket exists:

1. A timed span owner (the continuous-batching engine's decode, prefill
   and chunk steps) runs a step key's first dispatch under
   :class:`step_scope` with capture on; ``kernels.ops`` appends one
   :class:`GemmRecord` per registry call it dispatched — shapes, actual
   dtypes, resolved backend, tile source.
2. :func:`aggregate` folds the records into a :class:`StepWorkload`:
   per-(backend, family, shape-bucket, tile-source) FLOP/byte totals costed
   with :mod:`repro_torch.core.roofline` (``gemm_bytes`` at honest widths,
   against the H100 SXM unless told otherwise).
3. Each later dispatch of that key calls :func:`observe_step` with its
   measured wall seconds. The step time is attributed to the workload
   entries in proportion to their roofline-bound seconds, yielding
   per-entry ``gemm.achieved_gflops`` and ``gemm.roofline_fraction``
   histograms plus a ``gemm.device_seconds`` counter — the ranking feed for
   ``launch.stats top``. On the card the bracket is the host's wall time of
   an eagerly issued step, so the fraction reads how far the host keeps the
   card from its bound. Tuned entries also feed the drift-retune seam
   (``kernels.ops._note_util_observation``, :func:`kernels.ops.on_util_gap`).

**Step scopes.** The reference counts, captures and audits GEMMs at trace
time inside ``jit``: once per compiled step, never per executed step. The
port is eager, so an engine runs every step inside :class:`step_scope`:
the first dispatch of a step key captures (every GEMM call counts into
``gemm.calls`` and yields a record), later dispatches of the key are quiet
(``kernels.ops`` skips its per-call telemetry), and no call inside any
scope is audited (a tracer is never audited either). Direct ``ops`` calls
outside a scope count every call, as the reference's eager calls do. One
difference remains: the reference's layer-scan traces one period's body,
so its records hold one period's GEMMs; the port's hold every layer's.
The two agree at one period (the reduced configs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.roofline import H100_SXM, HardwareSpec, gemm_bytes

from . import metrics as _metrics

__all__ = [
    "GemmRecord",
    "WorkloadEntry",
    "StepWorkload",
    "capture_gemms",
    "record_call",
    "capturing",
    "step_scope",
    "StepKeys",
    "in_step",
    "step_quiet",
    "shape_bucket",
    "aggregate",
    "observe_step",
    "GFLOPS_BUCKETS",
    "FRACTION_BUCKETS",
]

# GFLOP/s bucket edges: wide enough to cover the CPU's plain versions
# (sub-GFLOP/s) through the card's GEMMs (hundreds of TFLOP/s).
GFLOPS_BUCKETS: Tuple[float, ...] = (
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
    1e3, 3e3, 1e4, 3e4, 1e5, 3e5,
)

# Roofline-fraction edges: log-spaced below 0.1 (CPU runs scored against the
# H100, and host-bound steps on the card, live here) and fine near 1.0
# (where the paper's claim lives).
FRACTION_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0,
)


@dataclasses.dataclass(frozen=True)
class GemmRecord:
    """One registry GEMM call as captured by ``kernels.ops`` on a step key's
    first dispatch (or a direct call under :class:`capture_gemms`)."""

    shape_family: str  # "dense" | "grouped"
    backend: str
    family: str  # numerics family: "fp" | "q8"
    m: int
    k: int
    n: int
    g: int  # 0 for dense
    a_dtype: str
    b_dtype: str
    out_dtype: str
    tile_source: str  # "tuned" | "heuristic"
    tile_key: Tuple  # (backend, shape family, m, k, n, g, itemsize)


def _pow2_bucket(x: int) -> int:
    """Round up to the next power of two (M varies with live batch size;
    bucketing it keeps label cardinality bounded on a serving process)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def shape_bucket(rec: GemmRecord) -> str:
    """Stable label for a GEMM shape class: M pow2-bucketed, K/N/G exact
    (weights don't change shape at runtime; the activation row count does)."""
    mb = _pow2_bucket(rec.m)
    if rec.shape_family == "grouped":
        return f"grouped:{rec.g}x{mb}x{rec.k}x{rec.n}"
    return f"dense:{mb}x{rec.k}x{rec.n}"


def _record_cost(
    rec: GemmRecord, hw: HardwareSpec
) -> Tuple[float, float, float]:
    """(flops, bytes, roofline_s) of one record at honest dtype widths."""
    groups = max(rec.g, 1)
    flops = 2.0 * rec.m * rec.k * rec.n * groups
    scale_elems = (rec.m + rec.n) if rec.family == "q8" else 0
    nbytes = groups * gemm_bytes(
        rec.m, rec.k, rec.n,
        a_dtype=rec.a_dtype, b_dtype=rec.b_dtype, out_dtype=rec.out_dtype,
        scale_elems=scale_elems,
    )
    roofline_s = max(flops / hw.peak_flops, nbytes / hw.hbm_bw)
    return flops, float(nbytes), roofline_s


@dataclasses.dataclass
class WorkloadEntry:
    """Aggregated cost of one (backend, family, bucket, tile) class."""

    backend: str
    family: str
    bucket: str
    tile_source: str
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    roofline_s: float = 0.0
    tile_key: Optional[Tuple] = None  # one representative record's key


# Keyed by (backend, family, bucket, tile_source).
StepWorkload = Dict[Tuple[str, str, str, str], WorkloadEntry]


# --------------------------------------------------------------------------
# Capture (fed by kernels.ops._note_gemm_call)
# --------------------------------------------------------------------------

_CAPTURE: List[list] = []


def capturing() -> bool:
    """Cheap guard ``kernels.ops`` checks before building a record."""
    return bool(_CAPTURE)


def record_call(rec: GemmRecord) -> None:
    for records in _CAPTURE:
        records.append(rec)


class capture_gemms:
    """Context manager collecting every :class:`GemmRecord` the registry
    emits while active. Nestable. Inside a quiet :class:`step_scope` the
    registry emits nothing."""

    def __enter__(self) -> List[GemmRecord]:
        self._records: List[GemmRecord] = []
        _CAPTURE.append(self._records)
        return self._records

    def __exit__(self, *exc):
        # Identity-based detach: equal contents must not make one capture
        # pop another's list.
        for i in range(len(_CAPTURE) - 1, -1, -1):
            if _CAPTURE[i] is self._records:
                del _CAPTURE[i]
                break
        return False


# --------------------------------------------------------------------------
# Engine step scopes (the port's analogue of a jit trace)
# --------------------------------------------------------------------------

# One flag per open scope: True while it captures (its step key's first
# dispatch), False while it is quiet.
_STEPS: List[bool] = []


def in_step() -> bool:
    """Inside an engine step (no audit: a served step's output is the
    analogue of a tracer)."""
    return bool(_STEPS)


def step_quiet() -> bool:
    """Inside a quiet step scope: ``kernels.ops`` skips its per-call
    telemetry (the reference's cache-hit dispatch runs no Python)."""
    return bool(_STEPS) and not _STEPS[-1]


class step_scope:
    """Bracket one engine step dispatch.

    ``capture=True`` (a step key's first dispatch): GEMM calls count into
    ``gemm.calls`` and their records are collected; ``__enter__`` returns
    the record list. ``capture=False``: GEMM calls pay no per-call
    telemetry; ``__enter__`` returns None. Either way nothing inside is
    audited. Host-side only.
    """

    def __init__(self, capture: bool) -> None:
        self.capture = bool(capture)
        self._cap: Optional[capture_gemms] = None

    def __enter__(self) -> Optional[List[GemmRecord]]:
        _STEPS.append(self.capture)
        if self.capture:
            self._cap = capture_gemms()
            return self._cap.__enter__()
        return None

    def __exit__(self, *exc):
        if self._cap is not None:
            self._cap.__exit__(*exc)
            self._cap = None
        _STEPS.pop()
        return False


class StepKeys:
    """One engine's step keys, and the policy that a key's first dispatch
    captures while later dispatches are quiet.

    ``dispatch(key, kind)`` returns the :class:`StepDispatch` to run one
    step under. With ``hardware`` (a callable giving the spec to cost
    against) the keys also carry attribution: a capturing dispatch stores
    the key's aggregated workload in ``workloads``, a later dispatch
    exposes it as ``workload`` for the caller to charge its measured wall
    time to, and a key first dispatched with telemetry off captures on its
    first dispatch with telemetry on and counts ``gemm.attr_fallback`` (the
    reference's abstract re-trace). Without ``hardware`` (an engine that
    attributes nothing) a key captures on its first dispatch only.
    """

    def __init__(self, hardware: Optional[Callable[[], HardwareSpec]] = None) -> None:
        self._hardware = hardware
        self._seen: set = set()
        self.workloads: Dict[tuple, StepWorkload] = {}

    def dispatch(self, key: tuple, kind: str = "step") -> "StepDispatch":
        return StepDispatch(self, key, kind)


class StepDispatch:
    """One dispatch of a :class:`StepKeys` key under :class:`step_scope`.

    The capturing dispatch charges no wall time (on the card it may include
    the kernels' build); ``workload`` is None then, and whenever the keys
    carry no attribution or telemetry is off.
    """

    __slots__ = ("_keys", "_key", "_kind", "_first", "_scope", "_recs", "workload")

    def __init__(self, keys: StepKeys, key: tuple, kind: str) -> None:
        self._keys, self._key, self._kind = keys, key, kind
        self.workload: Optional[StepWorkload] = None

    def __enter__(self) -> "StepDispatch":
        keys = self._keys
        self._first = self._key not in keys._seen
        keys._seen.add(self._key)
        refill = keys._hardware is not None and self._key not in keys.workloads
        self._scope = step_scope(_metrics.enabled() and (self._first or refill))
        self._recs = self._scope.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._scope.__exit__(*exc)
        keys = self._keys
        if exc[0] is not None or keys._hardware is None:
            return False
        if self._recs is not None:
            if self._recs:
                keys.workloads[self._key] = aggregate(self._recs, hw=keys._hardware())
            if self._first:
                return False
            _metrics.counter("gemm.attr_fallback", step=self._kind).inc()
        self.workload = keys.workloads.get(self._key)
        return False


# --------------------------------------------------------------------------
# Aggregation + attribution
# --------------------------------------------------------------------------


def aggregate(
    records: Sequence[GemmRecord], *, hw: HardwareSpec = H100_SXM
) -> StepWorkload:
    """Fold captured records into per-class cost totals (roofline-costed;
    ``hw`` defaults to the port's card, never the reference's chip)."""
    workload: StepWorkload = {}
    for rec in records:
        bucket = shape_bucket(rec)
        key = (rec.backend, rec.family, bucket, rec.tile_source)
        entry = workload.get(key)
        if entry is None:
            entry = workload[key] = WorkloadEntry(
                backend=rec.backend, family=rec.family, bucket=bucket,
                tile_source=rec.tile_source, tile_key=rec.tile_key,
            )
        flops, nbytes, roofline_s = _record_cost(rec, hw)
        entry.calls += 1
        entry.flops += flops
        entry.bytes += nbytes
        entry.roofline_s += roofline_s
    return workload


def observe_step(workload: StepWorkload, seconds: float) -> None:
    """Attribute one measured execution of ``workload`` to its entries.

    ``seconds`` (host-wall time of the step) is split across the entries
    in proportion to their roofline-bound seconds — the best proportional
    estimate available without per-kernel device profiling — then each
    share scores its entry's ``gemm.achieved_gflops`` and
    ``gemm.roofline_fraction`` and accrues ``gemm.device_seconds``. Every
    entry of one step gets the same fraction: the step's roofline seconds
    over its wall time. On the card, where a step is issued eagerly and not
    synchronized, ``gemm.device_seconds`` and ``gemm.achieved_gflops`` are
    host wall time apportioned by roofline cost, not device measurements:
    a device time comes from a ``torch.profiler`` trace. Tuned entries
    additionally feed ``ops.on_util_gap`` drift detection.
    """
    if seconds <= 0.0 or not workload or not _metrics.enabled():
        return
    total_roofline = sum(e.roofline_s for e in workload.values())
    if total_roofline <= 0.0:
        return
    for entry in workload.values():
        share = entry.roofline_s / total_roofline
        attributed = seconds * share
        if attributed <= 0.0:
            continue
        achieved_gflops = entry.flops / attributed / 1e9
        fraction = entry.roofline_s / attributed
        labels = dict(
            backend=entry.backend, family=entry.family,
            bucket=entry.bucket, tile=entry.tile_source,
        )
        _metrics.histogram(
            "gemm.achieved_gflops", buckets=GFLOPS_BUCKETS, **labels
        ).observe(achieved_gflops)
        _metrics.histogram(
            "gemm.roofline_fraction", buckets=FRACTION_BUCKETS, **labels
        ).observe(fraction)
        _metrics.counter("gemm.device_seconds", **labels).inc(attributed)
        if entry.tile_key is not None:
            # Lazy import: ops imports this module.
            from repro_torch.kernels import ops as _ops

            _ops._note_util_observation(entry.tile_key, fraction, entry.tile_source)
