"""Zero-dependency, thread-safe metrics registry (the ``repro_torch.obs`` core).

The port of :mod:`repro.obs.metrics`, whole. Three instrument kinds, all
label-aware:

* :class:`Counter` — monotonically increasing float (``inc``);
* :class:`Gauge` — last-written value (``set``/``add``);
* :class:`Histogram` — fixed bucket edges for export plus a bounded raw
  sample reservoir for exact percentiles (``observe``/``percentile``).

Instruments are owned by a :class:`Registry`; the module-level default
registry is what the instrumented layers (``kernels.ops``,
``serve.continuous``) write into. ``snapshot()`` renders the whole registry
as a nested dict (stable key order), ``to_json`` / ``prometheus_text``
export it, and ``reset()`` drops every instrument. The port's registry is
its own: a process that loads both packages keeps two.

**The hard-off switch.** ``REPRO_METRICS=0`` (or ``set_enabled(False)``)
makes every instrument-fetch return a shared null object whose methods are
no-ops. All instrumentation is *host-side Python*: it never launches a
kernel, copies to or from the card, or synchronizes, so the sequence of
device kernels of a step is the same with telemetry on or off. The off
switch drops even the host-side dict lookups on hot host loops.

``REPRO_METRICS_DUMP=<path>`` registers an atexit hook that writes the
final snapshot as JSON (``python -m repro_torch.launch.stats snapshot
--file <path>``). The JAX package reads the same variable; the port's hook
writes only when its registry holds an instrument, so a process that
filled only the other package's registry keeps that package's dump.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_BUCKETS",
    "enabled",
    "set_enabled",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "reset",
    "to_json",
    "prometheus_text",
    "percentile",
]

# Latency-oriented default bucket edges (seconds). Wide enough for CPU-run
# decode steps (~ms..s) and card steps (~us..ms) alike; histograms accept
# custom edges where these don't fit.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# Bounded raw-sample reservoir per histogram: exact percentiles over the most
# recent observations without unbounded memory on long-lived servers.
_SAMPLE_CAP = 4096

_ENV_VAR = "REPRO_METRICS"
_DUMP_ENV_VAR = "REPRO_METRICS_DUMP"

_enabled = os.environ.get(_ENV_VAR, "1") not in ("0", "false", "off")


def enabled() -> bool:
    """Whether telemetry is on (default yes; ``REPRO_METRICS=0`` hard-off)."""
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Flip telemetry on/off at runtime; returns the previous state.

    Affects instrument fetches made *after* the call (handles are looked up
    per call site invocation, so instrumented layers react immediately).
    """
    global _enabled
    prev = _enabled
    _enabled = bool(flag)
    return prev


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Exact linear-interpolated percentile of ``values`` (q in [0, 100]).

    Returns ``None`` for an empty sequence — "no data" and "zero latency"
    are different facts, and conflating them once poisoned a serving
    report. Consumers serialize it as JSON ``null``.
    """
    if not values:
        return None
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


LabelValue = Union[str, int, float, bool]
LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, LabelValue]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonic counter. ``inc`` is the only mutator (never decreases)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-value instrument (queue depth, occupancy, tokens/s)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram plus a bounded raw-sample reservoir.

    Buckets (cumulative, Prometheus-style ``le`` semantics on export) give a
    stable wire format; the reservoir (most recent ``_SAMPLE_CAP``
    observations) gives exact percentiles — bucket interpolation would make
    ``ttft_p99`` a function of edge placement, which is exactly the kind of
    lie a utilization paper repro must not tell.
    """

    __slots__ = ("_lock", "edges", "bucket_counts", "count", "sum",
                 "min", "max", "_samples")

    def __init__(self, buckets: Optional[Iterable[float]] = None) -> None:
        self._lock = threading.Lock()
        self.edges: Tuple[float, ...] = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.bucket_counts = [0] * (len(self.edges) + 1)  # +1 = +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: collections.deque = collections.deque(maxlen=_SAMPLE_CAP)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            while i < len(self.edges) and v > self.edges[i]:
                i += 1
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._samples.append(v)

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            return percentile(list(self._samples), q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def samples_seen(self) -> int:
        """Total observations, whether or not still in the reservoir."""
        return self.count

    @property
    def samples_dropped(self) -> int:
        """Observations evicted from the reservoir: >0 means percentiles are
        computed over a trailing window, not the full history."""
        with self._lock:
            return self.count - len(self._samples)


class _NullInstrument:
    """The disabled-mode stand-in: every method is a no-op, every read zero."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, n: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> Optional[float]:
        return None

    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0
    samples_seen = 0
    samples_dropped = 0


_NULL = _NullInstrument()


class Registry:
    """Named, labelled instruments behind one lock; snapshot/reset/export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[LabelKey, Counter]] = {}
        self._gauges: Dict[str, Dict[LabelKey, Gauge]] = {}
        self._histograms: Dict[str, Dict[LabelKey, Histogram]] = {}
        self._histogram_buckets: Dict[str, Tuple[float, ...]] = {}

    # -- instrument fetch (get-or-create) -----------------------------------

    def counter(self, name: str, /, **labels: LabelValue) -> Counter:
        if not _enabled:
            return _NULL  # type: ignore[return-value]
        key = _label_key(labels)
        with self._lock:
            fam = self._counters.setdefault(name, {})
            inst = fam.get(key)
            if inst is None:
                inst = fam[key] = Counter()
        return inst

    def gauge(self, name: str, /, **labels: LabelValue) -> Gauge:
        if not _enabled:
            return _NULL  # type: ignore[return-value]
        key = _label_key(labels)
        with self._lock:
            fam = self._gauges.setdefault(name, {})
            inst = fam.get(key)
            if inst is None:
                inst = fam[key] = Gauge()
        return inst

    def histogram(
        self, name: str, /, *, buckets: Optional[Iterable[float]] = None,
        **labels: LabelValue,
    ) -> Histogram:
        if not _enabled:
            return _NULL  # type: ignore[return-value]
        key = _label_key(labels)
        with self._lock:
            fam = self._histograms.setdefault(name, {})
            inst = fam.get(key)
            if inst is None:
                if buckets is not None:
                    self._histogram_buckets[name] = tuple(sorted(buckets))
                inst = fam[key] = Histogram(
                    self._histogram_buckets.get(name)
                )
        return inst

    # -- snapshot / reset ----------------------------------------------------

    def snapshot(self) -> Dict[str, Dict]:
        """Nested dict of every instrument, keys sorted for stable diffs.

        Shape::

            {"counters":   {name: {label_str: value}},
             "gauges":     {name: {label_str: value}},
             "histograms": {name: {label_str: {count, sum, mean, min, max,
                                               p50, p90, p99,
                                               samples_seen, samples_dropped,
                                               percentile_mode,
                                               buckets: {le: cumulative}}}}}

        Percentiles are ``None`` when the histogram is empty. Once the
        bounded reservoir evicts old samples, they cover a trailing window
        only — ``percentile_mode`` says ``"exact"`` vs ``"windowed"`` so
        readers (``launch.stats``) can tag them honestly.
        """
        with self._lock:
            counters = {
                name: {k: inst.value for k, inst in fam.items()}
                for name, fam in self._counters.items()
            }
            gauges = {
                name: {k: inst.value for k, inst in fam.items()}
                for name, fam in self._gauges.items()
            }
            hists = {
                name: dict(fam) for name, fam in self._histograms.items()
            }
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(counters):
            out["counters"][name] = {
                _label_str(k): counters[name][k] for k in sorted(counters[name])
            }
        for name in sorted(gauges):
            out["gauges"][name] = {
                _label_str(k): gauges[name][k] for k in sorted(gauges[name])
            }
        for name in sorted(hists):
            fam_out = {}
            for k in sorted(hists[name]):
                h = hists[name][k]
                cumulative = 0
                buckets = {}
                for edge, c in zip(h.edges, h.bucket_counts):
                    cumulative += c
                    buckets[repr(edge)] = cumulative
                buckets["+Inf"] = h.count
                dropped = h.samples_dropped
                fam_out[_label_str(k)] = {
                    "count": h.count,
                    "sum": h.sum,
                    "mean": h.mean,
                    "min": h.min if h.count else 0.0,
                    "max": h.max if h.count else 0.0,
                    "p50": h.percentile(50),
                    "p90": h.percentile(90),
                    "p99": h.percentile(99),
                    "samples_seen": h.samples_seen,
                    "samples_dropped": dropped,
                    "percentile_mode": "windowed" if dropped else "exact",
                    "buckets": buckets,
                }
            out["histograms"][name] = fam_out
        return out

    def reset(self) -> None:
        """Drop every instrument (names, labels, values). Tests call this
        between cases; long-lived processes normally never do."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._histogram_buckets.clear()


# ---------------------------------------------------------------------------
# Default registry + module-level convenience API
# ---------------------------------------------------------------------------

_REGISTRY = Registry()


def counter(name: str, /, **labels: LabelValue) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, /, **labels: LabelValue) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(
    name: str, /, *, buckets: Optional[Iterable[float]] = None,
    **labels: LabelValue,
) -> Histogram:
    return _REGISTRY.histogram(name, buckets=buckets, **labels)


def snapshot() -> Dict[str, Dict]:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()


def to_json(indent: Optional[int] = 2) -> str:
    return json.dumps(snapshot(), indent=indent, sort_keys=False)


# ---------------------------------------------------------------------------
# Prometheus text exposition (rendered from a snapshot dict, so the CLI can
# export a file written by another process)
# ---------------------------------------------------------------------------


def _prom_name(name: str, suffix: str = "") -> str:
    safe = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return f"repro_{safe}{suffix}"


def _prom_labels(label_str: str) -> str:
    if not label_str:
        return ""
    pairs = [p.split("=", 1) for p in label_str.split(",")]
    inner = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + inner + "}"


def prometheus_text(snap: Optional[Dict[str, Dict]] = None) -> str:
    """Prometheus text-exposition rendering of ``snap`` (default: the live
    default registry). Counters get ``_total``, histograms the standard
    ``_bucket``/``_sum``/``_count`` triplet."""
    snap = snap if snap is not None else snapshot()
    lines: List[str] = []
    for name, fam in snap.get("counters", {}).items():
        pname = _prom_name(name, "_total")
        lines.append(f"# TYPE {pname} counter")
        for label_str, value in fam.items():
            lines.append(f"{pname}{_prom_labels(label_str)} {value}")
    for name, fam in snap.get("gauges", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        for label_str, value in fam.items():
            lines.append(f"{pname}{_prom_labels(label_str)} {value}")
    for name, fam in snap.get("histograms", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for label_str, h in fam.items():
            for le, cum in h["buckets"].items():
                le_pairs = (label_str + "," if label_str else "") + f"le={le}"
                lines.append(f"{pname}_bucket{_prom_labels(le_pairs)} {cum}")
            lines.append(f"{pname}_sum{_prom_labels(label_str)} {h['sum']}")
            lines.append(f"{pname}_count{_prom_labels(label_str)} {h['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# REPRO_METRICS_DUMP: write the final snapshot at interpreter exit
# ---------------------------------------------------------------------------

_dump_path = os.environ.get(_DUMP_ENV_VAR)
if _dump_path:
    import atexit

    def _dump_at_exit(path: str = _dump_path) -> None:
        snap = snapshot()
        if not any(snap.values()):
            return  # nothing recorded here: leave the path to the other package
        try:
            with open(path, "w") as f:
                json.dump(snap, f, indent=2)
        except OSError:
            pass  # a dump failure must never mask the run's own exit status

    atexit.register(_dump_at_exit)
